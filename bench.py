"""Benchmark: batched FISTA-TV 256² deblurring throughput (problems/s).

A problem is one 256×256 real image deblurred (9×9 Gaussian PSF through
`SeparableConvOperator`) with 50 FISTA iterations, each a normal-op
application and a TV-FGP prox of 10 dual iterations, solved through
`rt.solve_batched_fast` in batches of 64 per GPU. With several GPUs the
batch is sharded over them with `parallel.solve_batched_sharded`.

Refuses to run without a GPU. Timing ends every window in
`block_until_ready`. Prints the card's name and power limit, then ONE
JSON line: {"metric", "value", "unit", "device", ...}.
"""

from __future__ import annotations

import json
import time

import numpy as np

from tools.bench_suite import flagship
from tools.chip_common import (
    block,
    enable_compile_cache,
    gpu_name_and_power_limit,
    require_gpu,
)
from tools.np_reference import rel_err


def main():
    import jax

    enable_compile_cache()
    dev = require_gpu()
    n_dev = len(jax.devices())
    card = gpu_name_and_power_limit()
    print(card, flush=True)

    cfg = flagship(batch=64 * n_dev)
    if n_dev > 1:
        from rls_tpu.parallel import make_mesh, shard_batch, solve_batched_sharded

        mesh = make_mesh(axis_names=("batch",))
        B = shard_batch(cfg.B, mesh)
        run = lambda B_: solve_batched_sharded(cfg.solver, B_, mesh)  # noqa: E731
    else:
        B = jax.device_put(cfg.B, dev)
        run = cfg.run

    t0 = time.perf_counter()
    out = np.asarray(block(run(B)))
    first_call = time.perf_counter() - t0
    windows = []
    for _ in range(12):
        t0 = time.perf_counter()
        block(run(B))
        windows.append(time.perf_counter() - t0)

    saved = np.load(__file__.replace("bench.py", "bench_ref_f64.npz"))
    k = int(saved["n_ref"])
    parity = rel_err(out[:, :k], saved["x64"]) if np.array_equal(
        saved["b"], cfg.B[:, :k]) else None
    print(json.dumps({
        "metric": "fista_tv_256_batched_deblur_throughput",
        "value": cfg.count / float(np.median(windows)),
        "unit": "problems/s",
        "best_problems_per_s": cfg.count / min(windows),
        "windows_s": windows,
        "first_call_s": first_call,
        "parity_max_rel_err": parity,
        "peak_bytes_in_use": dev.memory_stats()["peak_bytes_in_use"],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": n_dev, "name_power_limit": card.splitlines()[0]},
    }))


if __name__ == "__main__":
    main()
