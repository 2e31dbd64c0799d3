"""Profile the flagship on one GPU: a `jax.profiler` trace of steady
batches reduced to device busy time, idle share and kernel time by class,
plus standalone timings of the two layers the solve is made of — the
TV-FGP prox and the normal operator — at the flagship's batch and width.

Prints a summary and writes the full reduction to
chiprun_out/trace_flagship.json (the raw trace stays under
chiprun_out/trace/).

Usage: python tools/trace_flagship.py
"""

from __future__ import annotations

import glob
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.bench_suite import flagship  # noqa: E402
from tools.chip_common import (  # noqa: E402
    CHECKOUT,
    block,
    enable_compile_cache,
    gpu_name_and_power_limit,
    require_gpu,
)

# published HBM bandwidth by device_kind (NVIDIA H100 SXM data sheet)
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
GEMM_MARKERS = ("gemm", "xmma", "cutlass", "cublas", "matmul", "dot")


def _union(intervals):
    """Total length covered by a set of (start, end) intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(path):
    """Device kernel events of an .xplane.pb: busy time, idle share over
    the span from the first to the last kernel, and kernel time by class
    (matmul library kernels vs XLA's own fusions)."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    events, lines = [], {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name}|{line.name}"] = len(evs)
            if line.name.startswith("Stream"):
                events += [(e.name, e.start_ns, e.end_ns) for e in evs]
    if not events:
        raise RuntimeError(f"no GPU kernel events in {path}; lines: {lines}")
    span = max(e for _, _, e in events) - min(s for _, s, _ in events)
    busy = _union([(s, e) for _, s, e in events])
    by_name = {}
    for name, s, e in events:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    gemm = sum(t for n, t in by_name.items() if any(m in n.lower() for m in GEMM_MARKERS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:25]
    return {
        "lines": lines, "kernels": len(events), "span_ns": span, "busy_ns": busy,
        "idle_share": 1.0 - busy / span, "gemm_ns": gemm,
        "other_ns": sum(by_name.values()) - gemm,
        "top_kernels_ns": top,
    }


def _time(fn, x, reps=20):
    block(fn(x))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(x)
    block(out)
    return (time.perf_counter() - t0) / reps


def main():
    import jax

    dev = require_gpu()
    if dev.device_kind not in HBM_BYTES_PER_S:
        raise SystemExit(f"no published HBM bandwidth for {dev.device_kind!r}")
    peak = HBM_BYTES_PER_S[dev.device_kind]
    enable_compile_cache()
    card = gpu_name_and_power_limit().splitlines()[0]
    out_dir = os.path.join(CHECKOUT, "chiprun_out")
    trace_dir = os.path.join(out_dir, "trace")
    os.makedirs(out_dir, exist_ok=True)

    cfg = flagship()
    s = cfg.solver
    n, batch, iters = cfg.B.shape[0], cfg.count, s.iterations
    tv_iters = s.reg.iterations_tv
    B = jax.device_put(cfg.B, dev)
    t0 = time.perf_counter()
    block(cfg.run(B))
    first = time.perf_counter() - t0
    steady = _time(cfg.run, B, reps=5)

    with jax.profiler.trace(trace_dir):
        for _ in range(3):
            block(cfg.run(B))
    path = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))[-1]
    try:
        red = reduce_trace(path)
    except RuntimeError as e:  # unrecognised trace layout: keep the timings
        print(f"[trace] {e}")
        red = None

    # the two layers alone, over the whole batch
    X = jax.device_put(np.asarray(cfg.B.T), dev)  # (batch, n) images
    lam = s.rho * s.reg.lam
    prox = jax.jit(jax.vmap(lambda x: s.reg.prox(x, lam)))
    normal = jax.jit(jax.vmap(s.AHA.mv))
    t_prox = _time(prox, X)
    t_normal = _time(normal, X)
    dual_iter = t_prox / tv_iters
    plane_bytes = 12 * batch * n * 4  # ~12 planes read+written per dual iteration
    result = {
        "card": card, "device_kind": dev.device_kind,
        "batch": batch, "n": n, "iterations": iters, "tv_iterations": tv_iters,
        "first_call_s": first, "steady_s_per_batch": steady,
        "problems_per_s": batch / steady,
        "trace": red, "trace_batches": 3,
        "prox_s_per_call": t_prox, "fgp_dual_iteration_s": dual_iter,
        "fgp_bytes_per_dual_iteration": plane_bytes,
        "fgp_share_of_hbm_peak": plane_bytes / dual_iter / peak,
        "normal_op_s_per_call": t_normal,
        "modelled_solve_s": iters * (t_prox + t_normal),
    }
    with open(os.path.join(out_dir, "trace_flagship.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(f"[trace] {card}; first call {first:.2f} s; steady {steady:.4f} s/batch "
          f"({batch / steady:.1f} problems/s)")
    if red:
        print(f"[trace] 3 batches: {red['kernels']} kernels, busy "
              f"{red['busy_ns'] / 1e6:.2f} ms of {red['span_ns'] / 1e6:.2f} ms, idle share "
              f"{red['idle_share']:.4f}; gemm {red['gemm_ns'] / 1e6:.2f} ms, other "
              f"{red['other_ns'] / 1e6:.2f} ms")
        for name, t in red["top_kernels_ns"][:12]:
            print(f"[trace]   {t / 1e6:9.3f} ms  {name[:110]}")
    print(f"[trace] FGP prox {t_prox * 1e3:.3f} ms/call = {dual_iter * 1e3:.4f} ms per dual "
          f"iteration across the batch, {plane_bytes / dual_iter / 1e9:.1f} GB/s = "
          f"{result['fgp_share_of_hbm_peak']:.3f} of {peak / 1e12:.2f} TB/s; normal op "
          f"{t_normal * 1e3:.3f} ms/call; modelled solve {result['modelled_solve_s']:.4f} s")


if __name__ == "__main__":
    main()
