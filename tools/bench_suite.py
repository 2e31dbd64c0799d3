"""Benchmark configurations: the flagship and one configuration per solver
family, each with a float64 numpy reference.

Every builder constructs its solver through the public entry points
(`rt.<Solver>.create`, operators, regularization terms), makes its data
from a seed on the host, and returns a `Config`. `chip_smoke.py` and
`bench.py` import the builders from here; the tests call them at tiny
sizes. The defaults are the benchmark sizes:

  flagship      FISTA + TV(FGP) deblurring, 256², 9×9 Gaussian PSF
                (SeparableConvOperator), 50 × 10 iterations, batch 64
  cgnr          CGNR + L2, dense 64×64 system (cond ≈ 4), 200 iterations
                (capped at 64 CG steps), batch 16
  fista_l1_cs   FISTA + L1 compressed sensing, subsampled DFT 256²
                (35 % of k-space), 60 iterations, batch 16
  admm_tv       ADMM + TV deblurring 256², 12 × (6 CG, 8 FGP), batch 16
  split_bregman SplitBregman L1 + TV, SENSE 128² × 6 coils, 4 × 8 × 8,
                batch 8 slices
  fista_dense   FISTA + L1 on a dense 256×512 CS system, 600 iterations,
                batch 16
  pdhg_tv8      PDHG + 8-direction TV deblurring 256², 200 iterations,
                batch 16
  kaczmarz      randomized Kaczmarz + positivity, 1024×256, 20 sweeps of
                64 rows, batch 16
  greedy        greedy randomized Kaczmarz, 512×64, 20 sweeps of 32 rows,
                batch 16 (through `solve_batched`)
  llr           one LLR prox call, 128² × 16 frames, 8×8 blocks

Usage: python tools/bench_suite.py   # times every configuration
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Callable

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools import np_reference as ref  # noqa: E402


@dataclasses.dataclass
class Config:
    """One benchmark configuration.

    ``run(B)`` solves the batch on the default device; ``reference(k)``
    returns the float64 solutions of the first ``k`` columns of ``B``;
    ``tol`` bounds the relative error against it, for the reason ``why``.
    ``count`` problems make one batch."""

    name: str
    run: Callable
    B: np.ndarray
    reference: Callable[[int], np.ndarray]
    tol: float
    why: str
    count: int
    solver: object = None


def _gauss_taps(k, var):
    g = np.exp(-((np.arange(k) - k // 2) ** 2) / (2 * var))
    return g / g.sum()


def _rects(rng, n, count, lo, hi, amp, margin):
    """Piecewise-constant phantom: `count` rectangles with sides in
    [lo, hi) and corners in [0, n − margin)."""
    img = np.zeros((n, n))
    for _ in range(count):
        i0, j0 = rng.integers(0, n - margin, size=2)
        w, h = rng.integers(lo, hi, size=2)
        img[i0:i0 + w, j0:j0 + h] += amp(rng)
    return img


def _columns(f, B, k):
    return np.stack([f(B[:, j].astype(np.float64)) for j in range(k)], axis=1)


# --------------------------------------------------------------------------
# flagship
# --------------------------------------------------------------------------


def flagship(n=256, batch=64, iterations=50, tv_iterations=10, seed=0):
    import rls_tpu as rt

    taps = _gauss_taps(9, 4.0)  # 9×9 Gaussian, σ = 2
    op = rt.SeparableConvOperator.from_taps(taps, taps, im_shape=(n, n))
    solver = rt.FISTA.create(
        op,
        reg=rt.TVRegularization(5e-4, shape=(n, n), iterations_tv=tv_iterations,
                                unroll=True),
        iterations=iterations, rho=0.95, rel_tol=0.0, track_residual=False,
    )
    rng = np.random.default_rng(seed)
    amp = lambda r: r.normal()  # noqa: E731
    X = np.stack([_rects(rng, n, 6, n // 16, n // 4, amp, n // 8).ravel()
                  for _ in range(batch)], axis=1)
    A64 = ref.SepConv(taps, taps, (n, n))
    B = np.stack([A64.mv(X[:, j]) for j in range(batch)], axis=1).astype(np.float32)
    tv = ref.tv_prox((n, n), None, tv_iterations)
    return Config(
        "flagship_fista_tv", lambda B_: rt.solve_batched_fast(solver, B_), B,
        lambda k: _columns(
            lambda b: ref.fista(A64, b, tv, 5e-4, 0.95, iterations,
                                track_residual=False), B, k),
        1e-3,
        "f32 over 50 FISTA × 10 FGP iterations; the fused-vs-composed bar "
        "this path was held to was 1e-3 relative",
        batch, solver,
    )


# --------------------------------------------------------------------------
# one configuration per solver family
# --------------------------------------------------------------------------


def cgnr(m=64, batch=16, iterations=200, seed=0):
    import jax.numpy as jnp

    import rls_tpu as rt

    rng = np.random.default_rng(seed)
    # well conditioned, so f32 CG meets the f64 solution closely and the
    # comparison measures the device's arithmetic, not CG's sensitivity
    A = (rng.normal(size=(m, m)) / np.sqrt(m) + 2.0 * np.eye(m)).astype(np.float32)
    B = (A.astype(np.float64) @ rng.normal(size=(m, batch))).astype(np.float32)
    solver = rt.CGNR.create(rt.DenseOperator(jnp.asarray(A)), reg=rt.L2Regularization(1e-6),
                            iterations=iterations)
    return Config(
        "cgnr_l2_dense", lambda B_: rt.solve_batched_fast(solver, B_), B,
        lambda k: _columns(lambda b: ref.cgnr(ref.Dense(A), b, 1e-6, iterations, m),
                           B, k),
        1e-4,
        "f32 CG on a system of condition ≈ 4; f64 parity bar of the "
        "reference's tests",
        batch, solver,
    )


def fista_l1_cs(n=256, frac=0.35, batch=16, iterations=60, seed=0):
    import rls_tpu as rt

    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(n * n, size=int(frac * n * n), replace=False))
    op = rt.SubsampledDFT2RealOperator.from_sample_idx(idx.astype(np.int32), (n, n))
    mask = np.zeros(n * n)
    mask[idx] = 1.0
    A64 = ref.SubsampledDFT(mask, (n, n))
    amp = lambda r: r.uniform(0.3, 1.0)  # noqa: E731
    X = np.stack([_rects(rng, n, 8, n // 32 + 1, n // 16 + 2, amp, n // 12).ravel()
                  for _ in range(batch)], axis=1)
    B = np.stack([A64.mv(X[:, j]) for j in range(batch)], axis=1).astype(np.float32)
    solver = rt.FISTA.create(op, reg=rt.L1Regularization(2e-3), iterations=iterations,
                             rho=0.95, rel_tol=0.0, track_residual=False)
    return Config(
        "fista_l1_cs_dft", lambda B_: rt.solve_batched_fast(solver, B_), B,
        lambda k: _columns(lambda b: ref.fista(A64, b, ref.soft_threshold, 2e-3,
                                               0.95, iterations,
                                               track_residual=False), B, k),
        1e-3, "f32 over 60 proximal-gradient steps on a unitary operator",
        batch, solver,
    )


def admm_tv(n=256, batch=16, iterations=12, cg_iterations=6, tv_iterations=8,
            seed=1):
    import rls_tpu as rt

    rng = np.random.default_rng(seed)
    taps = _gauss_taps(9, 4.0)
    op = rt.SeparableConvOperator.from_taps(taps, taps, im_shape=(n, n))
    A64 = ref.SepConv(taps, taps, (n, n))
    amp = lambda r: r.uniform(0.3, 1.0)  # noqa: E731
    X = np.stack([_rects(rng, n, 6, n // 16, n // 8 + 1, amp, n // 6).ravel()
                  for _ in range(batch)], axis=1)
    B = np.stack([A64.mv(X[:, j]) for j in range(batch)], axis=1).astype(np.float32)
    solver = rt.ADMM.create(
        op, reg=rt.TVRegularization(2e-3, shape=(n, n), iterations_tv=tv_iterations,
                                    unroll=True),
        iterations=iterations, iterations_cg=cg_iterations, unroll_cg=True, rho=0.1,
    )
    tv = ref.tv_prox((n, n), None, tv_iterations)
    return Config(
        "admm_tv_deblur", lambda B_: rt.solve_batched_fast(solver, B_), B,
        lambda k: _columns(lambda b: ref.admm(A64, b, [tv], [2e-3], [0.1],
                                              iterations, cg_iterations), B, k),
        1e-3, "f32 over 12 ADMM steps of 6 CG + 8 FGP iterations",
        batch, solver,
    )


def _coil_maps(rng, coils, h, w):
    yy, xx = np.mgrid[0:h, 0:w] / h
    maps = np.stack([
        (np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) * 2.0) + 0.15)
        * np.exp(1j * (cx * yy - cy * xx) * 2)
        for cy, cx in rng.uniform(0, 1, size=(coils, 2))
    ])
    return maps / np.sqrt((np.abs(maps) ** 2).sum(0))


def _sense_problem(h, coils, slices, seed):
    rng = np.random.default_rng(seed)
    maps = _coil_maps(rng, coils, h, h)
    mask = (rng.uniform(size=(h, h)) < 0.45).astype(np.float64)
    c = max(2, h // 12)
    mask[h // 2 - c:h // 2 + c, h // 2 - c:h // 2 + c] = 1.0
    A64 = ref.Sense(maps, mask, (h, h))
    X = []
    for _ in range(slices):
        im = np.zeros((h, h), np.complex128)
        for _ in range(5):
            i0, j0 = rng.integers(2, h - h // 4 - 2, 2)
            s = h // 5
            im[i0:i0 + s, j0:j0 + s] += rng.uniform(0.4, 1.0) * np.exp(1j * rng.uniform())
        X.append(np.concatenate([im.real.ravel(), im.imag.ravel()]))
    X = np.stack(X, axis=1)
    B = np.stack([A64.mv(X[:, j]) for j in range(slices)], axis=1).astype(np.float32)
    return maps, mask, A64, B


def split_bregman(h=128, coils=6, slices=8, iterations=4, iterations_inner=8,
                  cg_iterations=8, tv_iterations=5, seed=0):
    import rls_tpu as rt

    maps, mask, A64, B = _sense_problem(h, coils, slices, seed)
    op = rt.SenseDFT2RealOperator.from_maps(maps.astype(np.complex64), mask, (h, h))
    n2 = 2 * h * h
    solver = rt.SplitBregman.create(
        op,
        reg=[rt.L21Regularization(1e-4, slices=2),
             rt.TVRegularization(1e-4, shape=(2, h, h), dims=(1, 2),
                                 iterations_tv=tv_iterations, unroll=True)],
        reg_trafo=[rt.IdentityOperator(n2, np.float32),
                   rt.IdentityOperator(n2, np.float32)],
        iterations=iterations, iterations_inner=iterations_inner,
        iterations_cg=cg_iterations, unroll_cg=True, rho=[0.01, 0.01],
    )
    proxes = [ref.l21_prox(2), ref.tv_prox((2, h, h), (1, 2), tv_iterations)]
    return Config(
        "split_bregman_sense", lambda B_: rt.solve_batched_fast(solver, B_), B,
        lambda k: _columns(lambda b: ref.split_bregman(
            A64, b, proxes, [1e-4, 1e-4], [0.01, 0.01], iterations,
            iterations_inner, cg_iterations), B, k),
        1e-3,
        "f32 over 32 inner ADMM steps whose Bregman updates integrate "
        "the residual",
        slices, solver,
    )


def fista_dense(m=256, n=512, batch=16, iterations=600, seed=0):
    import jax.numpy as jnp

    import rls_tpu as rt

    rng = np.random.default_rng(seed)
    A = (rng.normal(size=(m, n)) / np.sqrt(m)).astype(np.float32)
    X = rng.normal(size=(n, batch)) * (rng.uniform(size=(n, batch)) < 0.05)
    B = (A.astype(np.float64) @ X).astype(np.float32)
    rho = 0.95 / float(np.linalg.norm(A.astype(np.float64), 2) ** 2)
    solver = rt.FISTA.create(rt.DenseOperator(jnp.asarray(A)), reg=rt.L1Regularization(1e-4),
                             iterations=iterations, rho=rho, track_residual=False)
    return Config(
        "fista_l1_dense", lambda B_: rt.solve_batched_fast(solver, B_), B,
        lambda k: _columns(lambda b: ref.fista(ref.Dense(A), b, ref.soft_threshold,
                                               1e-4, rho, iterations,
                                               track_residual=False), B, k),
        3e-2,
        "over 600 f32 steps roundoff flips soft-threshold support "
        "decisions of the LASSO trajectory; the CPU's f32 run is 9.4e-3 "
        "from the f64 one",
        batch, solver,
    )


def pdhg_tv8(n=256, batch=16, iterations=200, sigma=0.0625, seed=1):
    import rls_tpu as rt

    rng = np.random.default_rng(seed)
    taps = _gauss_taps(9, 4.0)
    op = rt.SeparableConvOperator.from_taps(taps, taps, im_shape=(n, n))
    A64 = ref.SepConv(taps, taps, (n, n))
    amp = lambda r: r.uniform(0.3, 1.0)  # noqa: E731
    X = np.stack([_rects(rng, n, 6, n // 16, n // 8 + 1, amp, n // 6).ravel()
                  for _ in range(batch)], axis=1)
    B = np.stack([A64.mv(X[:, j]) for j in range(batch)], axis=1).astype(np.float32)
    solver = rt.PDHG.create(op, reg=rt.TVRegularization(5e-3, shape=(n, n)),
                            iterations=iterations, sigma=sigma)
    tau = float(solver.tau)
    return Config(
        "pdhg_tv8_deblur", lambda B_: rt.solve_batched_fast(solver, B_), B,
        lambda k: _columns(lambda b: ref.pdhg(A64, b, ref.Grad8((n, n)),
                                              ref.tv_conj_8dir((n, n)), 5e-3,
                                              sigma, tau, iterations), B, k),
        3e-2,
        "the reference's 8-direction conjugate prox takes sign(p) of "
        "near-zero dual entries, so f32 roundoff flips directions over 200 "
        "steps; the CPU's f32 run is 1.5e-2 from the f64 one",
        batch, solver,
    )


def _kaczmarz_system(rng, m, n, density):
    A = rng.normal(size=(m, n)).astype(np.float32)
    A[rng.uniform(size=A.shape) > density] = 0.0
    return A


def kaczmarz(m=1024, n=256, batch=16, sweeps=20, frac=0.0625, seed=0):
    import jax.numpy as jnp

    import rls_tpu as rt

    rng = np.random.default_rng(seed)
    A = _kaczmarz_system(rng, m, n, 0.3)
    X = np.abs(rng.normal(size=(n, batch)))
    B = (A.astype(np.float64) @ X).astype(np.float32)
    solver = rt.Kaczmarz.create(
        rt.DenseOperator(jnp.asarray(A)), reg=[rt.L2Regularization(1e-6), rt.PositiveRegularization()],
        iterations=sweeps, randomized=True, sub_matrix_fraction=frac,
        precompute_order=True,
    )
    order = np.asarray(solver.precomputed_order)
    return Config(
        "kaczmarz_randomized", lambda B_: rt.solve_batched_fast(solver, B_), B,
        lambda k: _columns(lambda b: ref.kaczmarz(A, b, 1e-6, order,
                                                  proxes=[ref.positive]), B, k),
        1e-3, "f32 over 1280 sequential row projections",
        batch, solver,
    )


def greedy(m=512, n=64, batch=16, sweeps=20, frac=0.0625, seed=0):
    import jax
    import jax.numpy as jnp

    import rls_tpu as rt

    rng = np.random.default_rng(seed)
    A = _kaczmarz_system(rng, m, n, 0.5)
    X = rng.normal(size=(n, batch))
    B = (A.astype(np.float64) @ X).astype(np.float32)
    solver = rt.Kaczmarz.create(rt.DenseOperator(jnp.asarray(A)), reg=rt.L2Regularization(1e-6),
                                iterations=sweeps, greedy_randomized=True,
                                sub_matrix_fraction=frac)
    return Config(
        "kaczmarz_greedy", lambda B_: jax.jit(rt.solve_batched)(solver, B_), B,
        lambda k: _columns(lambda b: ref.tikhonov_lstsq(A, b, 1e-6), B, k),
        1e-4,
        "greedy rows are drawn from JAX's PRNG, so the reference is the "
        "least-squares fixed point, which 640 row projections reach on "
        "this consistent system",
        batch, solver,
    )


def llr(h=128, frames=16, block=8, lam=0.5, seed=0):
    import jax

    import rls_tpu as rt

    rng = np.random.default_rng(seed)
    # low-rank dynamic series plus noise: each block holds a rank-2 signal
    t = np.linspace(0, 1, frames)
    basis = np.stack([np.ones(frames), np.sin(2 * np.pi * t)])
    coef = rng.normal(size=(h, h, 2))
    img = coef @ basis + 0.1 * rng.normal(size=(h, h, frames))
    x = img.astype(np.float32).reshape(-1, 1)
    reg = rt.LLRRegularization(lam, shape=(h, h), block_size=(block, block),
                               randshift=False)
    prox = jax.jit(reg.prox)
    return Config(
        "llr_prox", lambda B_: prox(B_[:, 0])[:, None], x,
        lambda k: ref.svt_blocks(img, (block, block), lam).reshape(-1, 1),
        1e-4, "one batched f32 SVT of 256 blocks of 64×16",
        1, reg,
    )


SUITE = (cgnr, fista_l1_cs, admm_tv, split_bregman, fista_dense, pdhg_tv8,
         kaczmarz, greedy, llr)


def main():
    import json
    import time

    import jax

    from tools.chip_common import block, enable_compile_cache

    enable_compile_cache()
    for build in (flagship,) + SUITE:
        cfg = build()
        B = jax.device_put(cfg.B)
        t0 = time.perf_counter()
        block(cfg.run(B))
        compile_s = time.perf_counter() - t0
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            out = cfg.run(B)
        block(out)
        dt = (time.perf_counter() - t0) / reps
        print(json.dumps({"config": cfg.name, "first_call_s": round(compile_s, 3),
                          "seconds_per_batch": dt,
                          "problems_per_s": cfg.count / dt,
                          "device": jax.devices()[0].device_kind}))


if __name__ == "__main__":
    main()
