"""The composed solver path against the plain float64 numpy references
(tools/np_reference.py): one case per configuration, each run through the
three batched drivers — `solve_batched_fast` (unrolled, no early exit),
`solve_batched` (masked while-loop) and `solve` on one column."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rls_tpu as rt
from tools import np_reference as ref

K = 3  # problems per batch


def _taps(k, var=1.0):
    g = np.exp(-((np.arange(k) - k // 2) ** 2) / (2 * var))
    return g / g.sum()


def _deblur(rng, n=16, k=5, var=1.0):
    taps = _taps(k, var)
    op = rt.SeparableConvOperator.from_taps(taps, taps, im_shape=(n, n))
    A64 = ref.SepConv(taps, taps, (n, n))
    X = np.zeros((n * n, K))
    for j in range(K):
        img = np.zeros((n, n))
        for _ in range(3):
            i0, j0 = rng.integers(0, n - 5, 2)
            img[i0:i0 + 5, j0:j0 + 5] += rng.uniform(0.5, 1.0)
        X[:, j] = img.ravel()
    B = np.stack([A64.mv(X[:, j]) for j in range(K)], axis=1)
    return op, A64, (B + 0.01 * rng.normal(size=B.shape)).astype(np.float32)


def _pgm_tv(name, restart="none", rel_tol=None):
    def build(rng):
        n = 16
        op, A64, B = _deblur(rng, n)
        cls = getattr(rt, name)
        kw = dict(restart=restart) if name != "OptISTA" else {}
        # long enough, and λ large enough, that the restarts fire
        lam, rho, it = 2e-2, 0.9, 30
        s = cls.create(op, reg=rt.TVRegularization(lam, shape=(n, n), iterations_tv=4,
                                                   unroll=True),
                       iterations=it, rho=rho, rel_tol=rel_tol, **kw)
        tv = ref.tv_prox((n, n), None, 4)

        def reference(b, early_exit):
            tol = (rel_tol or 0.0) if early_exit else 0.0
            if name == "FISTA":
                return ref.fista(A64, b, tv, lam, rho, it, restart, rel_tol=tol)
            if name == "POGM":
                return ref.pogm(A64, b, tv, lam, rho, it, restart, rel_tol=tol)
            return ref.optista(A64, b, tv, lam, rho, it)

        return s, B, reference
    return build


def _admm_tv(positive=False, k=5, var=1.0):
    def build(rng):
        n = 16
        op, A64, B = _deblur(rng, n, k, var)
        regs = [rt.TVRegularization(2e-3, shape=(n, n), iterations_tv=4, unroll=True)]
        if positive:
            regs.append(rt.PositiveRegularization())
        s = rt.ADMM.create(op, reg=regs, iterations=5, iterations_cg=4, unroll_cg=True,
                           rho=0.1)
        proj = [ref.positive] if positive else []
        tv = ref.tv_prox((n, n), None, 4)
        return s, B, lambda b, _: ref.admm(A64, b, [tv], [2e-3], [0.1], 5, 4, proj=proj)
    return build


def _sense(rng, h=16, coils=3):
    from tools.bench_suite import _sense_problem

    maps, mask, A64, B = _sense_problem(h, coils, K, int(rng.integers(1 << 30)))
    op = rt.SenseDFT2RealOperator.from_maps(maps.astype(np.complex64), mask, (h, h))
    return op, A64, B


def _split_bregman_sense(rng):
    h = 16
    op, A64, B = _sense(rng, h)
    n2 = 2 * h * h
    s = rt.SplitBregman.create(
        op, reg=[rt.L21Regularization(1e-3, slices=2),
                 rt.TVRegularization(1e-3, shape=(2, h, h), dims=(1, 2),
                                     iterations_tv=3, unroll=True)],
        reg_trafo=[rt.IdentityOperator(n2, np.float32), rt.IdentityOperator(n2, np.float32)],
        iterations=2, iterations_inner=3, iterations_cg=4, unroll_cg=True, rho=[0.05, 0.05])
    proxes = [ref.l21_prox(2), ref.tv_prox((2, h, h), (1, 2), 3)]
    return s, B, lambda b, _: ref.split_bregman(A64, b, proxes, [1e-3, 1e-3], [0.05, 0.05],
                                                2, 3, 4)


def _fista_l21_sense(rng):
    op, A64, B = _sense(rng)
    s = rt.FISTA.create(op, reg=rt.L21Regularization(2e-3, slices=2), iterations=15,
                        rho=0.9, track_residual=False)
    return s, B, lambda b, _: ref.fista(A64, b, ref.l21_prox(2), 2e-3, 0.9, 15,
                                        track_residual=False)


def _fista_l1_dft(rng):
    n = 16
    idx = np.sort(rng.choice(n * n, size=n * n // 3, replace=False))
    op = rt.SubsampledDFT2RealOperator.from_sample_idx(jnp.asarray(idx, jnp.int32), (n, n))
    mask = np.zeros(n * n)
    mask[idx] = 1.0
    A64 = ref.SubsampledDFT(mask, (n, n))
    X = rng.normal(size=(n * n, K)) * (rng.uniform(size=(n * n, K)) < 0.2)
    B = np.stack([A64.mv(X[:, j]) for j in range(K)], axis=1).astype(np.float32)
    s = rt.FISTA.create(op, reg=rt.L1Regularization(1e-3), iterations=15, rho=0.95,
                        track_residual=False)
    return s, B, lambda b, _: ref.fista(A64, b, ref.soft_threshold, 1e-3, 0.95, 15,
                                        track_residual=False)


def _dense(rng, m, n, complex_=False):
    A = rng.normal(size=(m, n)) / np.sqrt(n)
    if complex_:
        A = A + 1j * rng.normal(size=(m, n)) / np.sqrt(n)
    return A.astype(np.complex64 if complex_ else np.float32)


def _cgnr(kind):
    def build(rng):
        m, n = 24, 12
        cplx_A = kind == "complex"
        A = _dense(rng, m, n, cplx_A) + 2.0 * np.eye(m, n, dtype=np.float32)
        B = rng.normal(size=(m, K))
        if kind in ("complex", "real_A_complex_b"):
            B = B + 1j * rng.normal(size=(m, K))
        B = B.astype(np.complex64 if np.iscomplexobj(B) else np.float32)
        norm = rt.MeasurementBasedNormalization() if kind == "normalized" else rt.NoNormalization()
        s = rt.CGNR.create(rt.DenseOperator(jnp.asarray(A)), reg=rt.L2Regularization(1e-2),
                           normalize_reg=norm, iterations=8)

        def reference(b, _):
            scale = np.sum(np.abs(b)) / b.size if kind == "normalized" else 1.0
            return ref.cgnr(ref.Dense(A), b, 1e-2 * scale, 8, n)

        return s, B, reference
    return build


def _pdhg(kind):
    def build(rng):
        n = 16
        op, A64, B = _deblur(rng, n)
        if kind == "l1":
            s = rt.PDHG.create(op, reg=rt.L1Regularization(1e-3), iterations=20, sigma=0.5)
            trafo, conj = ref.Identity(), ref.ball_clamp
        else:
            s = rt.PDHG.create(op, reg=rt.TVRegularization(1e-3, shape=(n, n)),
                               iterations=20, sigma=0.5,
                               tv_scheme="8dir" if kind == "tv8" else "isotropic")
            if kind == "tv8":
                trafo, conj = ref.Grad8((n, n)), ref.tv_conj_8dir((n, n))
            else:
                trafo, conj = ref.Gradient((n, n)), ref.ball_clamp
        tau = float(s.tau)
        return s, B, lambda b, _: ref.pdhg(A64, b, trafo, conj, 1e-3, 0.5, tau, 20)
    return build


def _pgm_dense(name, complex_=False):
    def build(rng):
        m, n = 24, 40
        A = _dense(rng, m, n, complex_)
        X = rng.normal(size=(n, K)) * (rng.uniform(size=(n, K)) < 0.2)
        if complex_:
            X = X + 1j * rng.normal(size=(n, K)) * (X != 0)
        B = (A.astype(np.complex128 if complex_ else np.float64) @ X).astype(A.dtype)
        rho = 0.9 / float(np.linalg.norm(A.astype(np.complex128), 2) ** 2)
        s = getattr(rt, name).create(rt.DenseOperator(jnp.asarray(A)),
                                     reg=rt.L1Regularization(1e-3), iterations=25, rho=rho)
        solver = {"FISTA": ref.fista, "OptISTA": ref.optista, "POGM": ref.pogm}[name]
        return s, B, lambda b, _: solver(ref.Dense(A), b, ref.soft_threshold, 1e-3, rho, 25)
    return build


def _kaczmarz(kind):
    def build(rng):
        m, n = 32, 12
        A = rng.normal(size=(m, n)).astype(np.float32)
        if kind == "padded_csr":
            A[rng.uniform(size=A.shape) < 0.5] = 0.0
        X = np.abs(rng.normal(size=(n, K)))
        B = (A.astype(np.float64) @ X).astype(np.float32)
        op = (rt.PaddedCSROperator.from_dense(A) if kind == "padded_csr"
              else rt.DenseOperator(jnp.asarray(A)))
        if kind == "greedy":
            s = rt.Kaczmarz.create(op, reg=rt.L2Regularization(1e-6), iterations=30,
                                   greedy_randomized=True, sub_matrix_fraction=0.5)
            return s, B, lambda b, _: ref.tikhonov_lstsq(A, b, 1e-6)
        s = rt.Kaczmarz.create(op, reg=[rt.L2Regularization(1e-3), rt.PositiveRegularization()],
                               iterations=4, randomized=kind == "randomized",
                               sub_matrix_fraction=0.5, precompute_order=True)
        order = (np.asarray(s.precomputed_order) if kind == "randomized"
                 else [np.arange(m)] * 4)
        return s, B, lambda b, _: ref.kaczmarz(A, b, 1e-3, order, proxes=[ref.positive])
    return build


CASES = {
    "pgm_tv_fista": _pgm_tv("FISTA"),
    "pgm_tv_fista_restart": _pgm_tv("FISTA", restart="gradient"),
    "pgm_tv_fista_gradient_mapping": _pgm_tv("FISTA", restart="gradient_mapping"),
    "pgm_tv_fista_early_exit": _pgm_tv("FISTA", rel_tol=0.05),
    "pgm_tv_optista": _pgm_tv("OptISTA"),
    "pgm_tv_pogm": _pgm_tv("POGM"),
    "pgm_tv_pogm_restart": _pgm_tv("POGM", restart="gradient"),
    "pgm_tv_pogm_early_exit": _pgm_tv("POGM", rel_tol=0.05),
    "admm_tv_positive": _admm_tv(positive=True),
    "admm_tv_long_taps": _admm_tv(k=13, var=8.0),
    "splitbregman_sense": _split_bregman_sense,
    "fista_l21_sense": _fista_l21_sense,
    "fista_l1_dft": _fista_l1_dft,
    "cgnr_real": _cgnr("real"),
    "cgnr_complex": _cgnr("complex"),
    "cgnr_real_A_complex_b": _cgnr("real_A_complex_b"),
    "cgnr_normalized": _cgnr("normalized"),
    "pdhg_tv8": _pdhg("tv8"),
    "pdhg_isotropic": _pdhg("isotropic"),
    "pdhg_l1": _pdhg("l1"),
    "pgm_dense_fista": _pgm_dense("FISTA"),
    "pgm_dense_fista_complex": _pgm_dense("FISTA", complex_=True),
    "pgm_dense_optista": _pgm_dense("OptISTA"),
    "pgm_dense_pogm_complex": _pgm_dense("POGM", complex_=True),
    "kaczmarz_randomized": _kaczmarz("randomized"),
    "kaczmarz_cyclic": _kaczmarz("cyclic"),
    "kaczmarz_padded_csr": _kaczmarz("padded_csr"),
    "kaczmarz_greedy": _kaczmarz("greedy"),
}

_single = jax.jit(rt.solve)
_batched = jax.jit(rt.solve_batched)
DRIVERS = {
    "fast": (lambda s, B: rt.solve_batched_fast(s, B), K, False),
    "batched": (lambda s, B: _batched(s, jnp.asarray(B)), K, True),
    "single": (lambda s, B: _single(s, jnp.asarray(B[:, 0]))[:, None], 1, True),
}


@pytest.mark.parametrize("driver", sorted(DRIVERS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_composed_matches_f64_reference(rng, case, driver):
    solver, B, reference = CASES[case](rng)
    run, cols, early_exit = DRIVERS[driver]
    got = np.asarray(run(solver, B))
    assert got.shape[1] == cols and np.isfinite(got).all()
    B64 = B.astype(np.complex128 if np.iscomplexobj(B) else np.float64)
    want = np.stack([reference(B64[:, j], early_exit) for j in range(cols)], axis=1)
    assert got.shape == want.shape
    assert ref.rel_err(got, want) < 1e-4
