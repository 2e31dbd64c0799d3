"""2-process `jax.distributed` CPU test.

Spawns two real OS processes that initialize the JAX distributed runtime
against a local coordinator, build ONE global mesh over 2 processes x 2
virtual CPU devices, and run a batch-sharded CGNR solve — proving
`initialize_multihost` + `solve_batched_sharded` work across process
boundaries, not just on a single-process virtual mesh. The reference has
no distributed layer at all (SURVEY.md §2.6); this is the multi-host
seam. The workers pin themselves to the CPU before importing JAX.
"""

import os
import socket
import subprocess
import sys
import textwrap

_WORKER = textwrap.dedent(
    """
    import os, sys
    proc_id = int(sys.argv[1]); port = sys.argv[2]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    sys.path.insert(0, {repo!r})
    import jax
    jax.config.update("jax_platforms", "cpu")
    from rls_tpu.parallel.multihost import (
        initialize_multihost, is_multihost, global_mesh)
    initialize_multihost(f"127.0.0.1:{{port}}", num_processes=2,
                         process_id=proc_id)
    assert is_multihost(), "expected process_count == 2"
    import numpy as np, jax.numpy as jnp
    import rls_tpu as rt
    from rls_tpu.parallel.mesh import batch_sharding, solve_batched_sharded

    mesh = global_mesh()
    assert len(jax.devices()) == 4, jax.devices()
    rng = np.random.default_rng(0)
    m = 16
    # well-conditioned system: I + small perturbation
    A = (np.eye(m) + 0.1 * rng.normal(size=(m, m))).astype(np.float32)
    X = rng.normal(size=(m, 4)).astype(np.float32)
    B = jnp.asarray(A @ X)
    s = rt.CGNR.create(rt.DenseOperator(jnp.asarray(A)),
                       reg=rt.L2Regularization(1e-8), iterations=60)
    out = solve_batched_sharded(s, B, mesh)
    # output must actually be sharded over the global batch axis
    assert out.sharding.is_equivalent_to(batch_sharding(mesh), out.ndim), (
        out.sharding)
    from jax.experimental import multihost_utils
    got = np.asarray(multihost_utils.process_allgather(out, tiled=True))
    err = np.linalg.norm(got - X) / np.linalg.norm(X)
    assert err < 1e-3, err
    print(f"proc{{proc_id}} OK err={{err:.2e}}", flush=True)
    """
)


def test_two_process_distributed_solve(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(
        _WORKER.format(repo=os.path.dirname(os.path.dirname(__file__)))
    )
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {
        k: v
        for k, v in os.environ.items()
        # the workers pin their own platform/device-count flags
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{i} failed:\n{out[-3000:]}"
        assert f"proc{i} OK" in out
