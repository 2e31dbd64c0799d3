"""Split-real twins of the complex solver/prox tests.

These twins run the complex semantics through real arrays only: the
complex system is built host-side in numpy, solved on device in the
split-real representation

    A_s = [[Re A, −Im A], [Im A, Re A]],  x_s = [Re x; Im x]

which is exactly the representation the split-real DFT/SENSE operators
use (rls_tpu/ops/dft_real.py), for runtimes without complex dtypes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rls_tpu as rt


def _split_system(A, x=None):
    """Host-side: complex (m, n) → real (2m, 2n) block matrix."""
    top = np.hstack([A.real, -A.imag])
    bot = np.hstack([A.imag, A.real])
    As = np.vstack([top, bot]).astype(np.float32)
    if x is None:
        return As
    xs = np.concatenate([x.real, x.imag]).astype(np.float32)
    return As, xs


def test_cgnr_split_real_twin(rng):
    """CGNR on the split-real system must recover the complex regularized
    solution (computed host-side in f64) — the real-arrays twin of the
    complex CGNR test."""
    m, n = 48, 24
    A = (rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))) / np.sqrt(m)
    xt = rng.normal(size=(n,)) + 1j * rng.normal(size=(n,))
    b = A @ xt
    lam = 1e-6
    # host f64 regularized solution of the complex normal equations
    x64 = np.linalg.solve(A.conj().T @ A + lam * np.eye(n), A.conj().T @ b)

    As, _ = _split_system(A, xt)
    bs = jnp.asarray(np.concatenate([b.real, b.imag]).astype(np.float32))
    s = rt.CGNR.create(
        rt.DenseOperator(jnp.asarray(As)),
        reg=rt.L2Regularization(lam), iterations=120,
    )
    xs = np.asarray(jax.jit(lambda bb: rt.solve(s, bb))(bs))
    got = xs[:n] + 1j * xs[n:]
    err = np.linalg.norm(got - x64) / np.linalg.norm(x64)
    assert err < 1e-3, err


def test_kaczmarz_split_real_twin(rng):
    """Kaczmarz row sweeps on the split-real system converge to the
    complex least-squares solution — real-arrays twin of the complex
    Kaczmarz test (row recurrence semantics, Kaczmarz.jl:303-317)."""
    m, n = 60, 16
    A = (rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))) / np.sqrt(m)
    xt = rng.normal(size=(n,)) + 1j * rng.normal(size=(n,))
    b = A @ xt

    As, _ = _split_system(A, xt)
    bs = jnp.asarray(np.concatenate([b.real, b.imag]).astype(np.float32))
    s = rt.Kaczmarz.create(
        rt.DenseOperator(jnp.asarray(As)),
        reg=rt.L2Regularization(1e-8), iterations=60,
    )
    xs = np.asarray(jax.jit(lambda bb: rt.solve(s, bb))(bs))
    got = xs[:n] + 1j * xs[n:]
    err = np.linalg.norm(got - xt) / np.linalg.norm(xt)
    assert err < 5e-2, err


def test_fista_l2_split_real_twin(rng):
    """FISTA + L2 on the split-real system: the L2 prox is a scalar
    multiply, which commutes with the split representation exactly."""
    m, n = 40, 20
    A = (rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))) / np.sqrt(m)
    xt = rng.normal(size=(n,)) + 1j * rng.normal(size=(n,))
    b = A @ xt
    lam = 1e-3
    x64 = np.linalg.solve(A.conj().T @ A + lam * np.eye(n), A.conj().T @ b)

    As, _ = _split_system(A, xt)
    bs = jnp.asarray(np.concatenate([b.real, b.imag]).astype(np.float32))
    s = rt.FISTA.create(
        rt.DenseOperator(jnp.asarray(As)),
        reg=rt.L2Regularization(lam), iterations=300,  # rho from power iter
    )
    xs = np.asarray(jax.jit(lambda bb: rt.solve(s, bb))(bs))
    got = xs[:n] + 1j * xs[n:]
    err = np.linalg.norm(got - x64) / np.linalg.norm(x64)
    assert err < 2e-2, err


def test_l1_prox_complex_semantics_via_real_planes(rng):
    """The complex L1 prox (magnitude soft-threshold, reference
    ProxL1.jl) evaluated on (re, im) REAL planes — the split-real
    formulation — must match the host-side complex prox."""
    n = 256
    z = rng.normal(size=(n,)) + 1j * rng.normal(size=(n,))
    lam = 0.3
    # host-side complex reference
    mag = np.abs(z)
    want = np.where(mag > 0, z * np.maximum(mag - lam, 0.0) / mag, 0.0)

    re = jnp.asarray(z.real.astype(np.float32))
    im = jnp.asarray(z.imag.astype(np.float32))

    @jax.jit
    def prox_planes(re, im):
        m = jnp.sqrt(re * re + im * im)
        scale = jnp.where(m > 0, jnp.maximum(m - lam, 0.0) / jnp.where(m > 0, m, 1.0), 0.0)
        return re * scale, im * scale

    gr, gi = prox_planes(re, im)
    got = np.asarray(gr) + 1j * np.asarray(gi)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # and the library's complex prox agrees
    lib = np.asarray(
        rt.L1Regularization(lam).prox(jnp.asarray(z.astype(np.complex64)), lam)
    )
    np.testing.assert_allclose(lib, want, atol=1e-5)


def test_dft_split_real_matches_host_fft(rng):
    """The split-real DFT operator's forward transform equals the
    host-computed complex FFT (real arrays only on device)."""
    n = 32
    x = rng.normal(size=(n * n,)).astype(np.float32)
    idx = np.sort(rng.choice(n * n, size=n * n // 2, replace=False))
    op = rt.SubsampledDFT2RealOperator.from_sample_idx(
        jnp.asarray(idx, jnp.int32), (n, n)
    )
    y = np.asarray(jax.jit(op.mv)(jnp.asarray(x)))
    F = np.fft.fft2(x.reshape(n, n).astype(np.float64), norm="ortho")
    mask = np.zeros(n * n)
    mask[idx] = 1.0
    mask = mask.reshape(n, n)
    want = np.concatenate([(F.real * mask).ravel(), (F.imag * mask).ravel()])
    np.testing.assert_allclose(y, want, atol=2e-4)
