"""Split-real AUTO-ROUTE equivalence tests.

`create_linear_solver` on a complex-free runtime transparently lowers a
complex dense problem to its split-real twin (models/split_real.py).
These tests force the route on CPU (RLS_TPU_COMPLEX_OK=0) and compare
against the NATIVE complex solve — proving the twin is the same
computation, not merely a convergent one. Krylov/PGM trajectories must
coincide to f32 roundoff; row-action sweeps differ (one complex row ==
two real rows) and are held to a convergence bound instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rls_tpu as rt
from rls_tpu.models.solvers import solve, solve_batched
from rls_tpu.models.split_real import (
    SplitRealSolver,
    assemble_vec,
    embed_matrix,
    embed_vec,
    twin_regularization,
)


@pytest.fixture()
def force_split_real(monkeypatch):
    from rls_tpu.models import split_real

    monkeypatch.setenv("RLS_TPU_COMPLEX_OK", "0")
    split_real.backend_supports_complex.cache_clear()
    yield
    split_real.backend_supports_complex.cache_clear()


def _complex_problem(rng, m=40, n=24):
    A = ((rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n)))
         / np.sqrt(m)).astype(np.complex64)
    xt = (rng.normal(size=(n,)) + 1j * rng.normal(size=(n,))).astype(
        np.complex64)
    return A, xt, A @ xt


def test_embed_assemble_roundtrip(rng):
    z = (rng.normal(size=(10, 3)) + 1j * rng.normal(size=(10, 3))).astype(
        np.complex64)
    np.testing.assert_allclose(assemble_vec(embed_vec(z)), z, atol=1e-7)
    A = (rng.normal(size=(6, 4)) + 1j * rng.normal(size=(6, 4))).astype(
        np.complex64)
    x = (rng.normal(size=(4,)) + 1j * rng.normal(size=(4,))).astype(
        np.complex64)
    got = assemble_vec(embed_matrix(A) @ embed_vec(x))
    np.testing.assert_allclose(got, A @ x, atol=1e-5)


# PDHG is excluded: its native reg set is {L1, TV} with solver-internal
# prox machinery, and the L1 twin is an L21 group prox — create raises a
# clear ValueError before any complex array could reach the device.
@pytest.mark.parametrize("name", ["CGNR", "FISTA", "OptISTA", "POGM",
                                  "ADMM", "Kaczmarz",
                                  "DirectSolver", "PseudoInverse"])
def test_route_matches_native_complex(rng, name, force_split_real):
    """Auto-routed complex solve == native complex solve (CPU reference).

    The split-real counterpart that needs no native complex support is
    test_route_solves_complex_system below."""
    A, xt, b = _complex_problem(rng)
    reg = (rt.L2Regularization(1e-4)
           if name in ("CGNR", "Kaczmarz", "DirectSolver", "PseudoInverse")
           else rt.L1Regularization(1e-4))
    kw = dict(iterations=150, kwarg_warning=False)
    s_tw = rt.create_linear_solver(name, A, reg=reg, **kw)
    assert isinstance(s_tw, SplitRealSolver)
    got = solve(s_tw, b)
    assert got.dtype == np.complex64

    # native complex path (allowed again)
    from rls_tpu.models import split_real

    split_real.backend_supports_complex.cache_clear()
    import os

    os.environ["RLS_TPU_COMPLEX_OK"] = "1"
    try:
        s_cx = rt.create_linear_solver(name, jnp.asarray(A), reg=reg, **kw)
        want = np.asarray(solve(s_cx, jnp.asarray(b)))
    finally:
        os.environ["RLS_TPU_COMPLEX_OK"] = "0"
        split_real.backend_supports_complex.cache_clear()
    scale = np.linalg.norm(want)
    # row-action sweeps reorder (2 real rows per complex row); everything
    # else coincides step-for-step up to f32 accumulation differences
    tol = 5e-2 if name == "Kaczmarz" else 1e-3
    assert np.linalg.norm(got - want) / scale < tol, name


def test_route_solves_complex_system(rng, force_split_real):
    """Census twin: complex data stays host-side numpy; the
    device sees only the real embedding. The routed CGNR solve must
    recover the complex f64 regularized solution."""
    A, xt, b = _complex_problem(rng, m=48, n=24)
    lam = 1e-6
    x64 = np.linalg.solve(
        A.conj().T.astype(np.complex128) @ A + lam * np.eye(24),
        A.conj().T @ b,
    )
    s = rt.create_linear_solver("CGNR", A, reg=rt.L2Regularization(lam),
                                iterations=120, kwarg_warning=False)
    assert isinstance(s, SplitRealSolver)
    got = solve(s, b)
    assert np.linalg.norm(got - x64) / np.linalg.norm(x64) < 1e-3


def test_route_batched_and_fast(rng, force_split_real):
    """Matrix-b routing through solve_batched and solve_batched_fast
    returns the hcat complex solution."""
    A, xt, b = _complex_problem(rng, m=32, n=16)
    B = np.stack([b, 2.0 * b], axis=1)
    s = rt.create_linear_solver("CGNR", A, reg=rt.L2Regularization(1e-5),
                                iterations=80, kwarg_warning=False)
    X = solve_batched(s, B)
    assert X.shape == (16, 2) and X.dtype == np.complex64
    np.testing.assert_allclose(X[:, 1], 2.0 * X[:, 0], rtol=1e-4, atol=1e-5)
    Xf = rt.solve_batched_fast(s, B)
    assert Xf.shape == (16, 2) and np.iscomplexobj(Xf)
    np.testing.assert_allclose(Xf[:, 0], X[:, 0], rtol=5e-3, atol=1e-4)


def test_twin_l1_prox_is_complex_soft_threshold(rng):
    """twin(L1) == L21(slices=2) must equal the complex magnitude soft
    threshold exactly."""
    n = 64
    z = (rng.normal(size=(n,)) + 1j * rng.normal(size=(n,))).astype(
        np.complex64)
    lam = 0.3
    tw = twin_regularization(rt.L1Regularization(lam), n)
    got = assemble_vec(np.asarray(tw.prox(jnp.asarray(embed_vec(z)))))
    want = np.asarray(rt.L1Regularization(lam).prox(jnp.asarray(z)))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_twin_tv_pair_is_complex_fgp(rng):
    """twin(TV) with pair_planes couples the FGP projection across the
    plane pair — must match the complex FGP trajectory exactly."""
    n = 16
    z = (rng.normal(size=(n * n,)) + 1j * rng.normal(size=(n * n,))).astype(
        np.complex64)
    lam = 0.2
    reg = rt.TVRegularization(lam, shape=(n, n), iterations_tv=7)
    tw = twin_regularization(reg, n * n)
    got = assemble_vec(np.asarray(tw.prox(jnp.asarray(embed_vec(z)))))
    want = np.asarray(reg.prox(jnp.asarray(z)))
    np.testing.assert_allclose(got, want, atol=2e-6)
    # value couples the modulus the same way
    gv = float(tw.value(jnp.asarray(embed_vec(z))))
    wv = float(reg.value(jnp.asarray(z)))
    np.testing.assert_allclose(gv, wv, rtol=1e-5)


def test_twin_projections(rng):
    """Real/Positive twins reproduce the complex projections."""
    n = 32
    z = (rng.normal(size=(n,)) + 1j * rng.normal(size=(n,))).astype(
        np.complex64)
    zs = jnp.asarray(embed_vec(z))
    tw_r = twin_regularization(rt.RealRegularization(), n)
    got = assemble_vec(np.asarray(tw_r.prox(zs)))
    want = np.asarray(rt.RealRegularization().prox(jnp.asarray(z)))
    np.testing.assert_allclose(got, want, atol=1e-7)
    tw_p = twin_regularization(rt.PositiveRegularization(), n)
    got = assemble_vec(np.asarray(tw_p.prox(zs)))
    want = np.asarray(rt.PositiveRegularization().prox(jnp.asarray(z)))
    np.testing.assert_allclose(got, want, atol=1e-7)


def test_route_rejections_are_informative(rng, force_split_real):
    """Unsupported pieces raise ValueError naming the issue, BEFORE any
    complex array could reach the device."""
    A = (rng.normal(size=(8, 6)) + 1j * rng.normal(size=(8, 6))).astype(
        np.complex64)
    with pytest.raises(ValueError, match="NoNormalization"):
        rt.create_linear_solver(
            "CGNR", A, reg=rt.L2Regularization(1e-4),
            normalize_reg=rt.MeasurementBasedNormalization(),
            kwarg_warning=False,
        )
    with pytest.raises(ValueError, match="no split-real twin"):
        rt.create_linear_solver(
            "FISTA", A, reg=rt.NuclearRegularization(1e-4, svt_shape=(3, 2)),
            kwarg_warning=False,
        )
