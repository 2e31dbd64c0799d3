"""SplitBregman with multiple regularizers (L1 + TV)
on a multi-coil MRI-style reconstruction, batched slices.

Multi-coil forward model: A = [S·F·C₁; S·F·C₂; ...] — coil sensitivities as
WeightingOperators composed with a subsampled FFT, vertically stacked.
"""

import jax
import jax.numpy as jnp
import numpy as np

import rls_tpu as rt
from rls_tpu import solve, solve_batched


def _multicoil_op(rng, n=16, ncoil=3, frac=0.6):
    n2 = n * n
    idx = np.sort(rng.choice(n2, size=int(n2 * frac), replace=False))
    idx[0] = 0
    fft = rt.SubsampledFFTOperator(
        sample_idx=jnp.asarray(idx, jnp.int32), im_shape=(n, n)
    )
    yy, xx = np.mgrid[0:n, 0:n] / n
    ops = []
    for c in range(ncoil):
        sens = (0.5 + 0.5 * np.exp(-((yy - c / ncoil) ** 2 + xx**2))).astype(
            np.complex64
        )
        coil = rt.ProdOperator(
            fft, rt.WeightingOperator(jnp.asarray(sens.reshape(-1)))
        )
        ops.append(coil)
    return rt.StackedOperator(ops=tuple(ops)), n


def test_multicoil_splitbregman(rng):
    A, n = _multicoil_op(rng)
    img = np.zeros((n, n), np.float32)
    img[4:12, 5:13] = 1.0
    xt = jnp.asarray(img.reshape(-1), jnp.complex64)
    b = A.mv(xt)

    grad = rt.GradientOperator(im_shape=(n, n), _dtype=jnp.complex64)
    eye = rt.IdentityOperator(n * n, jnp.complex64)
    s = rt.SplitBregman.create(
        A,
        reg=[rt.L1Regularization(1e-4), rt.L1Regularization(1e-4)],
        reg_trafo=[eye, grad],
        iterations=10,
        iterations_inner=30,
        iterations_cg=20,
        rho=[0.1, 0.1],
    )
    x = solve(s, b)
    err = float(jnp.linalg.norm(x - xt) / jnp.linalg.norm(xt))
    assert err < 0.1


def test_multicoil_batched_slices(rng):
    """Batched slices: columns of B are independent slice reconstructions."""
    A, n = _multicoil_op(rng)
    imgs = np.zeros((3, n, n), np.float32)
    imgs[0, 4:12, 5:13] = 1.0
    imgs[1, 2:8, 2:8] = 1.0
    imgs[2, 6:14, 8:15] = 0.5
    X = jnp.asarray(imgs.reshape(3, -1).T, jnp.complex64)  # (n², 3)
    B = jnp.stack([A.mv(X[:, k]) for k in range(3)], axis=1)

    s = rt.ADMM.create(
        A,
        reg=rt.L1Regularization(1e-4),
        iterations=100,
        iterations_cg=8,
        rho=0.01,
    )
    XR = solve_batched(s, B)
    for k in range(3):
        err = float(jnp.linalg.norm(XR[:, k] - X[:, k]) / jnp.linalg.norm(X[:, k]))
        assert err < 0.15, f"slice {k}: {err}"


def test_x64_parity_gate(rng):
    """The f64 parity references need x64: CGNR in x64 must match the
    analytic Tikhonov solution to 1e-6."""
    with jax.enable_x64():
        A = jnp.asarray(rng.normal(size=(24, 12)), jnp.float64)
        xt = jnp.asarray(rng.normal(size=(12,)), jnp.float64)
        b = A @ xt
        lam = 1e-3
        s = rt.CGNR.create(A, reg=rt.L2Regularization(lam), iterations=50)
        x = solve(s, b)
        x_ref = jnp.linalg.solve(
            A.T @ A + lam * jnp.eye(12, dtype=jnp.float64), A.T @ b
        )
        err = float(jnp.linalg.norm(x - x_ref) / jnp.linalg.norm(x_ref))
        assert err < 1e-6
