"""Multi-RHS batching and multi-device sharding.

Replaces the reference's thread-based multi-RHS scheduler
(docs/src/literate/howto/multi_threading.jl + src/MultiThreading.jl) with
the JAX path: `solve_batched` vmaps per-problem states with an
active-convergence mask; on a device mesh the batch axis is sharded and the
same program runs SPMD (run with
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu
to see it on a virtual mesh).
"""

import jax
import jax.numpy as jnp
import numpy as np

import rls_tpu as rt
from rls_tpu.parallel import make_mesh, solve_batched_sharded

rng = np.random.default_rng(0)
A = jnp.asarray(rng.normal(size=(48, 24)).astype(np.float32))
X = jnp.asarray(rng.normal(size=(24, 8)).astype(np.float32))
B = A @ X  # 8 problems as columns

solver = rt.FISTA.create(A, reg=rt.L1Regularization(1e-4), iterations=60)

# single device: vmapped batch with per-problem early stopping
Xr = rt.solve_batched(solver, B)
print("batched rel. error:", float(jnp.linalg.norm(Xr - X) / jnp.linalg.norm(X)))

# device mesh: shard the problem columns
if len(jax.devices()) > 1:
    mesh = make_mesh(axis_names=("batch",))
    Xs = solve_batched_sharded(solver, B, mesh)
    print("sharded matches:", bool(jnp.allclose(Xs, Xr, atol=1e-4)))
else:
    print("single device — rerun with a multi-device mesh for sharding")
