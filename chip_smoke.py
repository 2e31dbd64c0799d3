"""Smoke test of the solver suite on one NVIDIA GPU, in one process.

Phases (any exception or missed tolerance exits non-zero; the last line
is printed only when every phase passed):

  1. device    refuse anything but a GPU; print the device kind, count,
               the card's name and power limit, and the matmul precision
               in effect
  2. flagship  FISTA + TV deblurring 256², batch 64, 50 × 10 iterations
               through `rt.solve_batched_fast`: compile seconds, steady
               seconds per batch and problems/s, peak device memory, and
               the error against the committed f64 reference
               (bench_ref_f64.npz, written by tools/gen_bench_ref.py)
  3. suite     every solver family of tools/bench_suite.py once, each
               against its float64 numpy reference

``--four-cards`` runs only the multi-device paths on a 4-GPU machine:
the flagship at batch 256 through `parallel.solve_batched_sharded` against
the same problems on one card, and row-sharded CGNR against the unsharded
solve with its compiled HLO audited for an all-reduce and no all-gather.

``--small`` runs phases 1-3 at the tests' sizes (a quick rehearsal).

Usage: python chip_smoke.py [--four-cards | --small]
Last line: {"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tools import bench_suite as suite  # noqa: E402
from tools import np_reference as ref  # noqa: E402
from tools.chip_common import (  # noqa: E402
    block,
    compile_cache_dir,
    enable_compile_cache,
    gpu_name_and_power_limit,
    require_gpu,
)

REF_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_ref_f64.npz")

# the tests' sizes, for --small
SMALL = {
    "flagship": dict(n=32, batch=4, iterations=6, tv_iterations=3),
    "cgnr": dict(m=16, batch=3, iterations=40),
    "fista_l1_cs": dict(n=16, batch=3, iterations=10),
    "admm_tv": dict(n=16, batch=3, iterations=4, cg_iterations=3, tv_iterations=3),
    "split_bregman": dict(h=16, coils=3, slices=2, iterations=2, iterations_inner=3,
                          cg_iterations=3, tv_iterations=2),
    "fista_dense": dict(m=24, n=48, batch=3, iterations=50),
    "pdhg_tv8": dict(n=16, batch=3, iterations=20),
    "kaczmarz": dict(m=64, n=16, batch=3, sweeps=6, frac=0.25),
    "greedy": dict(m=64, n=8, batch=3, sweeps=10, frac=0.25),
    "llr": dict(h=16, frames=4, block=4),
}


def log(*parts):
    print(*parts, flush=True)


def phases(args):
    """The phases this invocation runs, in order."""
    if args.four_cards:
        return ["device", "sharded_flagship", "row_sharded_cgnr"]
    return ["device", "flagship", "suite"]


def last_line(dev, count):
    return json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}})


def _matmul_precision():
    """The default matmul precision setting and what it yields: the
    relative error of a 1024² f32 product against float64."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 1024, 1024)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    out = {}
    for name, prec in (("default", None), ("highest", jax.lax.Precision.HIGHEST)):
        got = np.asarray(jax.jit(lambda x, y: jnp.matmul(x, y, precision=prec))(a, b))
        out[name] = float(np.linalg.norm(got - exact) / np.linalg.norm(exact))
    return jax.config.jax_default_matmul_precision, out


def device_phase(expect):
    import jax

    dev = require_gpu()
    count = len(jax.devices())
    if count < expect:
        raise SystemExit(f"needs {expect} GPUs, found {count}")
    card = gpu_name_and_power_limit()
    log(f"[device] kind={dev.device_kind} count={count}")
    for line in card.splitlines():
        log(f"[device] nvidia-smi name,power.limit: {line}")
    cache = compile_cache_dir()
    entries = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    log(f"[device] compile cache {cache}: {entries} entries before this run")
    setting, errs = _matmul_precision()
    log(f"[device] jax_default_matmul_precision={setting}; f32 1024² matmul "
        f"rel err vs f64: default {errs['default']:.2e}, HIGHEST {errs['highest']:.2e}")
    return dev, count, card.splitlines()[0]


def _precision(cfg):
    """The precision a configuration's products run at."""
    import jax

    op = getattr(cfg.solver, "A", None)
    comp = getattr(op, "compensated", None)
    text = f"jax_default_matmul_precision={jax.config.jax_default_matmul_precision}"
    if op is not None:
        text += f", {type(op).__name__}" + (
            "" if comp is None else f" compensated={comp}")
    return text


def _timed(run, B, reps):
    t0 = time.perf_counter()
    out = block(run(B))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        block(run(B))
        times.append(time.perf_counter() - t0)
    return out, first, times


def _check(name, err, tol, why):
    log(f"[{name}] rel err vs f64 {err:.3e} (tol {tol:g}: {why})")
    if not err <= tol:
        raise AssertionError(f"{name}: rel err {err:.3e} > tol {tol:g}")


def flagship_phase(dev, card, small):
    import jax

    cfg = suite.flagship(**SMALL["flagship"]) if small else suite.flagship()
    B = jax.device_put(cfg.B, dev)
    out, first, times = _timed(cfg.run, B, reps=3 if small else 10)
    steady = float(np.median(times))
    n = int(np.sqrt(cfg.B.shape[0]))
    log(f"[flagship] FISTA+TV {n}x{n}, batch {cfg.count}, "
        f"{cfg.solver.iterations}x{cfg.solver.reg.iterations_tv} iterations, "
        "rt.solve_batched_fast")
    log(f"[flagship] first call {first:.2f} s; compile ≈ {first - steady:.2f} s (set-up)")
    log(f"[flagship] steady {steady:.4f} s/batch (min {min(times):.4f}), "
        f"{cfg.count / steady:.1f} problems/s on {card}")
    stats = dev.memory_stats() or {}
    log(f"[flagship] peak_bytes_in_use {stats.get('peak_bytes_in_use', 'not reported')}")
    log(f"[flagship] precision: {_precision(cfg)}")
    x = np.asarray(out)
    if not (np.isfinite(x).all() and x.shape == (cfg.B.shape[0], cfg.count)):
        raise AssertionError(f"flagship output shape {x.shape} or non-finite")
    if small:
        want = cfg.reference(2)
    else:
        saved = np.load(REF_PATH)
        k = int(saved["n_ref"])
        if not np.array_equal(saved["b"], cfg.B[:, :k]):
            raise AssertionError("flagship problem changed: run tools/gen_bench_ref.py")
        want = saved["x64"]
    _check("flagship", ref.rel_err(x[:, :want.shape[1]], want), cfg.tol, cfg.why)


def suite_phase(dev, card, small):
    import jax

    for build in suite.SUITE:
        cfg = build(**SMALL[build.__name__]) if small else build()
        B = jax.device_put(cfg.B, dev)
        out, first, times = _timed(cfg.run, B, reps=2)
        x = np.asarray(out)
        if not (np.isfinite(x).all() and x.shape[1] == cfg.B.shape[1]):
            raise AssertionError(f"{cfg.name}: output shape {x.shape} or non-finite")
        k = min(2, cfg.count)
        log(f"[{cfg.name}] first call {first:.2f} s, steady {min(times):.4f} s/batch "
            f"of {cfg.count} on {card}; precision: {_precision(cfg)}")
        _check(cfg.name, ref.rel_err(x[:, :k], cfg.reference(k)), cfg.tol, cfg.why)


def sharded_flagship_phase(card):
    import jax

    import rls_tpu as rt
    from rls_tpu.parallel import make_mesh, shard_batch, solve_batched_sharded

    cfg = suite.flagship(batch=256)
    mesh = make_mesh(axis_names=("batch",))
    one = jax.devices()[0]
    single = jax.jit(rt.solve_batched)
    sharded = lambda B_: solve_batched_sharded(cfg.solver, B_, mesh)  # noqa: E731
    x1, first1, t1 = _timed(lambda B_: single(cfg.solver, B_), jax.device_put(cfg.B, one), 3)
    x4, first4, t4 = _timed(sharded, shard_batch(cfg.B, mesh), 3)
    log(f"[sharded_flagship] batch 256 on {len(mesh.devices.flat)} cards: "
        f"{256 / min(t4):.1f} problems/s (first call {first4:.2f} s); one card: "
        f"{256 / min(t1):.1f} problems/s (first call {first1:.2f} s); {card}")
    x1, x4 = np.asarray(x1), np.asarray(x4)
    # a different per-card batch changes XLA's gemm and reduction order,
    # so the two f32 runs differ by about as much as either differs from
    # f64: hold both, and their difference, to the flagship's f64 bar
    diff = ref.rel_err(x4, x1)
    log(f"[sharded_flagship] max over problems of |sharded - single| / |single| = "
        f"{diff:.3e} (tol {cfg.tol:g})")
    if not diff <= cfg.tol:
        raise AssertionError(f"sharded flagship differs from one card by {diff:.3e}")
    want = cfg.reference(2)
    _check("sharded_flagship single card", ref.rel_err(x1[:, :2], want), cfg.tol, cfg.why)
    _check("sharded_flagship", ref.rel_err(x4[:, :2], want), cfg.tol, cfg.why)


def row_sharded_cgnr_phase(card):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    import rls_tpu as rt
    from rls_tpu.parallel import make_mesh, row_sharded_operator

    rng = np.random.default_rng(0)
    m, n = 16384, 1024  # 64 MiB f32, rows split over the cards
    mat = (rng.normal(size=(m, n)) / np.sqrt(m)).astype(np.float32)
    xt = rng.normal(size=n)
    b = (mat.astype(np.float64) @ xt).astype(np.float32)
    mesh = make_mesh(axis_names=("rows",))
    s_rows = rt.CGNR.create(row_sharded_operator(mat, mesh, "rows"),
                            reg=rt.L2Regularization(1e-6), iterations=50)
    b_rows = jax.device_put(b, NamedSharding(mesh, PartitionSpec("rows")))
    solve = jax.jit(rt.solve)
    hlo = solve.lower(s_rows, b_rows).compile().as_text()
    has_ar, has_ag = "all-reduce" in hlo, "all-gather" in hlo
    log(f"[row_sharded_cgnr] HLO audit: all-reduce={has_ar} all-gather={has_ag}")
    if not has_ar or has_ag:
        raise AssertionError("row-sharded CGNR: expected all-reduce and no all-gather")
    one = jax.devices()[0]
    s_one = rt.CGNR.create(rt.DenseOperator(jax.device_put(jnp.asarray(mat), one)),
                           reg=rt.L2Regularization(1e-6), iterations=50)
    x4, first4, t4 = _timed(lambda b_: solve(s_rows, b_), b_rows, 3)
    x1, first1, t1 = _timed(lambda b_: solve(s_one, b_), jax.device_put(b, one), 3)
    x1, x4 = np.asarray(x1), np.asarray(x4)
    diff = float(np.linalg.norm(x4 - x1) / np.linalg.norm(x1))
    log(f"[row_sharded_cgnr] {m}x{n}, 50 iterations: {len(mesh.devices.flat)} cards "
        f"{min(t4) * 1e3:.2f} ms, "
        f"one card {min(t1) * 1e3:.2f} ms; rel |sharded - single| = {diff:.3e}; {card}")
    if not diff <= 1e-4:
        raise AssertionError(f"row-sharded CGNR differs from one card by {diff:.3e}")
    want = ref.cgnr(ref.Dense(mat), b.astype(np.float64), 1e-6, 50, n)
    _check("row_sharded_cgnr", ref.rel_err(x4, want), 1e-4,
           "well-conditioned tall system (cond ≈ 1.7); f64 parity bar")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--four-cards", action="store_true",
                      help="run only the 4-GPU sharded paths")
    mode.add_argument("--small", action="store_true",
                      help="phases 1-3 at the tests' sizes")
    args = ap.parse_args(argv)
    require_gpu()  # before anything else touches JAX's configuration
    enable_compile_cache()
    expect = 4 if args.four_cards else 1
    dev = count = card = None
    for phase in phases(args):
        t0 = time.perf_counter()
        if phase == "device":
            dev, count, card = device_phase(expect)
        elif phase == "flagship":
            flagship_phase(dev, card, args.small)
        elif phase == "suite":
            suite_phase(dev, card, args.small)
        elif phase == "sharded_flagship":
            sharded_flagship_phase(card)
        elif phase == "row_sharded_cgnr":
            row_sharded_cgnr_phase(card)
        log(f"[{phase}] done in {time.perf_counter() - t0:.1f} s")
    print(last_line(dev, count), flush=True)


if __name__ == "__main__":
    main()
