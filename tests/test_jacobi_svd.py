"""Batched one-sided Jacobi SVD/SVT (ops/jacobi_svd.py) vs f64 LAPACK.

Its rotations use no matmul unit, so it must hold ~1e-5 everywhere the
nuclear / LLR proxes use it (reference ProxNuclear.jl:26-31,
ProxLLR.jl:43-88)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rls_tpu as rt
from rls_tpu.ops.jacobi_svd import jacobi_svd, jacobi_svdvals, svt_jacobi


def _svt_ref(a, lam):
    u, s, vt = np.linalg.svd(a.astype(np.float64), full_matrices=False)
    return (u * np.maximum(s - lam, 0)[..., None, :]) @ vt


@pytest.mark.parametrize(
    "shape", [(7, 16, 6), (3, 12, 12), (2, 40, 3), (4, 8, 5)]
)
def test_svt_jacobi_matches_f64(rng, shape):
    a = jnp.asarray(rng.normal(size=shape), jnp.float32)
    got = np.asarray(jax.jit(lambda m: svt_jacobi(m, 0.8))(a))
    ref = _svt_ref(np.asarray(a), 0.8)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-4


def test_jacobi_svd_factors(rng):
    a = jnp.asarray(rng.normal(size=(5, 24, 6)), jnp.float32)
    u, s, vt = jacobi_svd(a)
    an = np.asarray(a)
    s64 = np.linalg.svd(an.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(np.asarray(s), s64, rtol=1e-4, atol=1e-5)
    # reconstruction + orthogonality
    rec = np.asarray(u) * np.asarray(s)[..., None, :] @ np.asarray(vt)
    assert np.linalg.norm(rec - an) / np.linalg.norm(an) < 1e-4
    vtv = np.asarray(vt) @ np.asarray(vt).swapaxes(-1, -2)
    np.testing.assert_allclose(vtv, np.broadcast_to(np.eye(6), vtv.shape),
                               atol=1e-4)


def test_jacobi_svdvals_rankdef(rng):
    # rank-deficient: zero columns / duplicated columns must not NaN
    a = np.zeros((2, 10, 4), np.float32)
    a[:, :, 0] = rng.normal(size=(2, 10))
    a[:, :, 1] = a[:, :, 0]  # duplicate -> zero singular value
    s = np.asarray(jacobi_svdvals(jnp.asarray(a)))
    s64 = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    assert np.isfinite(s).all()
    np.testing.assert_allclose(s, s64, atol=1e-5)


def test_nuclear_prox_jacobi_matches_f64(rng):
    n = 24
    x = jnp.asarray(rng.normal(size=(n * n,)), jnp.float32)
    r_j = rt.NuclearRegularization(0.05, svt_shape=(n, n), svd_method="jacobi")
    # ground truth from f64 LAPACK, not the XLA path, whose inner products
    # may run at reduced matmul precision on an accelerator
    a = np.asarray(r_j.prox(x))
    b = _svt_ref(np.asarray(x).reshape(n, n), 0.05).reshape(-1)
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-4
    s64 = np.linalg.svd(np.asarray(x, np.float64).reshape(n, n),
                        compute_uv=False)
    np.testing.assert_allclose(float(r_j.value(x)), 0.05 * s64.sum(),
                               rtol=1e-4)


def test_llr_prox_jacobi_matches_xla(rng):
    shape, K = (16, 16), 5
    x = jnp.asarray(rng.normal(size=(shape[0] * shape[1] * K,)), jnp.float32)
    kw = dict(shape=shape, block_size=(4, 4), randshift=True)
    r_j = rt.LLRRegularization(0.05, svd_method="jacobi", **kw)
    r_x = rt.LLRRegularization(0.05, svd_method="xla", **kw)
    a, b = np.asarray(r_j.prox(x)), np.asarray(r_x.prox(x))
    # 5e-3 bound: XLA's SVD may run at reduced matmul precision on an
    # accelerator; on CPU both are ~1e-5 apart. The 1e-4 Jacobi-vs-f64
    # bar is covered by test_svt_jacobi_matches_f64.
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 5e-3


def test_llr_complex_falls_back_to_xla(rng):
    # complex input: auto must route to XLA SVD (Jacobi is real-only)
    shape, K = (8, 8), 3
    x = jnp.asarray(
        rng.normal(size=(64 * K,)) + 1j * rng.normal(size=(64 * K,)),
        jnp.complex64,
    )
    reg = rt.LLRRegularization(0.05, shape=shape, block_size=(4, 4),
                               randshift=False)
    out = np.asarray(reg.prox(x))
    assert out.dtype == np.complex64 and np.isfinite(out).all()


def test_auto_routes_f64_to_xla(rng):
    """float64 must not reach the f32-only Jacobi path (bit-split crashes
    on f64); "auto" falls back to XLA's SVD, which is accurate there."""
    from rls_tpu.models.prox import _use_jacobi

    # numpy arrays: jnp would silently downcast f64 -> f32 without x64,
    # and _use_jacobi only inspects .dtype/.shape
    assert not _use_jacobi(np.zeros((8, 6), np.float64), "auto")
    assert _use_jacobi(np.zeros((8, 6), np.float32), "auto")


def test_jacobi_scan_matches_unrolled(rng):
    """The lax.scan-over-rounds sweep loop (compile-time fix for larger
    blocks) must reproduce the Python-unrolled loop exactly — same math,
    same rotation order, only the gather indices become scan inputs."""
    for shape in ((18, 12), (3, 24, 20), (2, 9, 9)):
        a = jnp.asarray(rng.normal(size=shape), jnp.float32)
        np.testing.assert_allclose(
            np.asarray(svt_jacobi(a, 0.5, unroll=False)),
            np.asarray(svt_jacobi(a, 0.5, unroll=True)),
            rtol=0, atol=5e-5,
        )
        u0, s0, v0 = jacobi_svd(a, unroll=True)
        u1, s1, v1 = jacobi_svd(a, unroll=False)
        np.testing.assert_allclose(np.asarray(s1), np.asarray(s0),
                                   rtol=0, atol=5e-5)
        np.testing.assert_allclose(
            np.asarray(jacobi_svdvals(a, unroll=False)),
            np.asarray(jacobi_svdvals(a, unroll=True)),
            rtol=0, atol=5e-5,
        )
