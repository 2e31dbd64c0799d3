"""Kaczmarz specifics, mirroring /root/reference/test/testKaczmarz.jl:
vector-λ Tikhonov ≡ explicitly transformed system (:37-70), weighted
operator ≡ dense weighted matrix (:72-90), all randomization modes with both
normalizations (:94-127)."""

import jax.numpy as jnp
import numpy as np
import pytest

import rls_tpu as rt
from rls_tpu import solve


def _overdetermined(rng, m=12, n=6, complex_=False):
    if complex_:
        A = (rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))).astype(
            np.complex64
        )
        x = (rng.normal(size=(n,)) + 1j * rng.normal(size=(n,))).astype(np.complex64)
    else:
        A = rng.normal(size=(m, n)).astype(np.float32)
        x = rng.normal(size=(n,)).astype(np.float32)
    return jnp.asarray(A), jnp.asarray(x), jnp.asarray(A @ x)


@pytest.mark.parametrize("complex_", [False, True])
def test_kaczmarz_recovers(rng, complex_):
    A, xt, b = _overdetermined(rng, complex_=complex_)
    s = rt.Kaczmarz.create(A, reg=rt.L2Regularization(1e-5), iterations=100)
    x = solve(s, b)
    err = float(jnp.linalg.norm(x - xt) / jnp.linalg.norm(xt))
    assert err < 0.05


def test_vector_lambda_equals_transformed_system(rng):
    """Vector-λ Tikhonov must equal solving the explicitly transformed
    standard-form system (testKaczmarz.jl:37-70)."""
    A, xt, b = _overdetermined(rng)
    lam_vec = jnp.asarray(rng.uniform(0.5, 2.0, size=(6,)), jnp.float32)

    s_vec = rt.Kaczmarz.create(A, reg=rt.L2Regularization(lam_vec), iterations=60)
    x_vec = solve(s_vec, b)

    # explicit transform: Â = A diag(1/√λ), solve with λ=1, rescale
    inv_sqrt = 1.0 / jnp.sqrt(lam_vec)
    A_hat = A * inv_sqrt[None, :]
    s_std = rt.Kaczmarz.create(A_hat, reg=rt.L2Regularization(1.0), iterations=60)
    c = solve(s_std, b)
    x_ref = c * inv_sqrt

    np.testing.assert_allclose(np.asarray(x_vec), np.asarray(x_ref), atol=1e-4)


def test_weighted_operator_equals_dense(rng):
    """Weighting ∘ A product ≡ dense weighted matrix (testKaczmarz.jl:72-90)."""
    A, xt, b = _overdetermined(rng)
    w = jnp.asarray(rng.uniform(0.5, 1.5, size=(12,)), jnp.float32)
    prod = rt.ProdOperator(rt.WeightingOperator(w), rt.DenseOperator(A))
    dense = rt.DenseOperator(w[:, None] * A)
    bw = w * b
    s1 = rt.Kaczmarz.create(prod, reg=rt.L2Regularization(1e-5), iterations=50)
    s2 = rt.Kaczmarz.create(dense, reg=rt.L2Regularization(1e-5), iterations=50)
    x1 = solve(s1, bw)
    x2 = solve(s2, bw)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2), atol=1e-4)


@pytest.mark.parametrize(
    "kw",
    [
        {"shuffle_rows": True},
        {"randomized": True, "sub_matrix_fraction": 0.8},
        {"greedy_randomized": True},
        {"greedy_randomized": True, "theta": 0.5},
    ],
)
def test_randomization_modes(rng, kw):
    A, xt, b = _overdetermined(rng)
    s = rt.Kaczmarz.create(A, reg=rt.L2Regularization(1e-5), iterations=200, **kw)
    x = solve(s, b)
    err = float(jnp.linalg.norm(x - xt) / jnp.linalg.norm(xt))
    assert err < 0.1, f"{kw}: {err}"


@pytest.mark.parametrize(
    "norm", [rt.NoNormalization(), rt.MeasurementBasedNormalization(),
             rt.SystemMatrixBasedNormalization()]
)
def test_normalizations(rng, norm):
    A, xt, b = _overdetermined(rng)
    s = rt.Kaczmarz.create(
        A, reg=rt.L2Regularization(1e-6), iterations=100, normalize_reg=norm
    )
    x = solve(s, b)
    err = float(jnp.linalg.norm(x - xt) / jnp.linalg.norm(xt))
    assert err < 0.1


def test_kaczmarz_extra_reg_prox(rng):
    """L2 + positivity constraint applied per sweep."""
    A, xt, b = _overdetermined(rng)
    xt_pos = jnp.abs(xt)
    b = A @ xt_pos
    s = rt.Kaczmarz.create(
        A,
        reg=[rt.L2Regularization(1e-5), rt.PositiveRegularization()],
        iterations=100,
    )
    x = solve(s, b)
    assert float(jnp.min(x)) >= 0
    err = float(jnp.linalg.norm(x - xt_pos) / jnp.linalg.norm(xt_pos))
    assert err < 0.1


def test_greedy_measurement_norm_rejected(rng):
    A, _, _ = _overdetermined(rng)
    with pytest.raises(ValueError):
        rt.Kaczmarz.create(
            A,
            reg=rt.L2Regularization(0.1),
            greedy_randomized=True,
            normalize_reg=rt.MeasurementBasedNormalization(),
        )


def test_sparse_kaczmarz(rng):
    dense = rng.normal(size=(20, 8)).astype(np.float32)
    dense[rng.uniform(size=dense.shape) < 0.5] = 0
    xt = rng.normal(size=(8,)).astype(np.float32)
    b = jnp.asarray(dense @ xt)
    op = rt.SparseOperator.from_dense(dense)
    s = rt.Kaczmarz.create(op, reg=rt.L2Regularization(1e-6), iterations=200)
    x = solve(s, b)
    err = float(np.linalg.norm(np.asarray(x) - xt) / np.linalg.norm(xt))
    assert err < 0.1


def test_vector_lambda_with_system_normalization(rng):
    """Vector-λ Tikhonov + SystemMatrixBasedNormalization must equal the
    explicitly pre-scaled-λ problem (the factor folds into λ at create,
    before the standard-form transform — regression: it used to be
    silently ignored for vector λ)."""
    A = jnp.asarray(rng.normal(size=(12, 6)), jnp.float32)
    xt = jnp.asarray(rng.normal(size=(6,)), jnp.float32)
    b = A @ xt
    lam_vec = jnp.asarray(rng.uniform(0.01, 0.1, size=(6,)), jnp.float32)
    factor = float(jnp.sum(jnp.abs(A) ** 2) / 6)
    s_norm = rt.Kaczmarz.create(
        A, reg=rt.L2Regularization(lam_vec),
        normalize_reg=rt.SystemMatrixBasedNormalization(), iterations=30,
    )
    s_explicit = rt.Kaczmarz.create(
        A, reg=rt.L2Regularization(lam_vec * factor), iterations=30,
    )
    x1 = np.asarray(solve(s_norm, b))
    x2 = np.asarray(solve(s_explicit, b))
    np.testing.assert_allclose(x1, x2, rtol=0, atol=1e-5)


def test_greedy_with_system_normalization(rng):
    """Greedy Kaczmarz + SystemMatrixBasedNormalization ≡ explicitly
    scaled λ (regression: greedy tables used the raw λ while the sweep
    denominators used the scaled one)."""
    A = jnp.asarray(rng.normal(size=(16, 6)), jnp.float32)
    xt = jnp.asarray(rng.normal(size=(6,)), jnp.float32)
    b = A @ xt
    lam = 0.05
    factor = float(jnp.sum(jnp.abs(A) ** 2) / 6)
    s_norm = rt.Kaczmarz.create(
        A, reg=rt.L2Regularization(lam),
        normalize_reg=rt.SystemMatrixBasedNormalization(),
        greedy_randomized=True, iterations=20,
    )
    s_explicit = rt.Kaczmarz.create(
        A, reg=rt.L2Regularization(lam * factor),
        greedy_randomized=True, iterations=20,
    )
    x1 = np.asarray(solve(s_norm, b))
    x2 = np.asarray(solve(s_explicit, b))
    np.testing.assert_allclose(x1, x2, rtol=0, atol=1e-5)


def test_kaczmarz_precomputed_order_scan_path(rng):
    """precompute_order=True must lower without jax.random.choice in the
    loop and produce a deterministic, convergent randomized solve."""
    m, n = 32, 16
    A = rng.normal(size=(m, n)).astype(np.float32)
    xt = rng.normal(size=(n,)).astype(np.float32)
    b = jnp.asarray(A @ xt)
    s = rt.Kaczmarz.create(
        rt.DenseOperator(jnp.asarray(A)), reg=rt.L2Regularization(1e-8),
        iterations=60, randomized=True, sub_matrix_fraction=0.5,
        precompute_order=True)
    from rls_tpu.models.solvers import solve_unrolled

    x1 = np.asarray(solve_unrolled(s, b))
    x2 = np.asarray(solve_unrolled(s, b))
    np.testing.assert_array_equal(x1, x2)
    assert np.linalg.norm(x1 - xt) / np.linalg.norm(xt) < 0.05


def test_padded_csr_matches_dense_ops(rng):
    """PaddedCSROperator mv/rmv/row/row_dot/row_axpy/rownorms must match
    the dense operator exactly (reference CSC specializations,
    Utils.jl:96-105, Kaczmarz.jl:532-539)."""
    m, n = 24, 12
    d = rng.normal(size=(m, n))
    d[rng.uniform(size=d.shape) < 0.7] = 0.0
    dj = jnp.asarray(d, jnp.float32)
    dense = rt.DenseOperator(dj)
    csr = rt.PaddedCSROperator.from_dense(d.astype(np.float32))
    x = jnp.asarray(rng.normal(size=(n,)), jnp.float32)
    y = jnp.asarray(rng.normal(size=(m,)), jnp.float32)
    np.testing.assert_allclose(np.asarray(csr.mv(x)), np.asarray(dense.mv(x)),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(csr.rmv(y)), np.asarray(dense.rmv(y)),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(csr.to_dense()), d, atol=1e-6)
    np.testing.assert_allclose(np.asarray(csr.row_norms_sq()),
                               np.asarray(dense.row_norms_sq()), rtol=1e-5)
    for i in (0, 5, m - 1):
        np.testing.assert_allclose(np.asarray(csr.row(i)), d[i], atol=1e-6)
        np.testing.assert_allclose(float(csr.row_dot(i, x)),
                                   float(dense.row_dot(i, x)), atol=1e-5)
        np.testing.assert_allclose(np.asarray(csr.row_axpy(x, i, 0.7)),
                                   np.asarray(dense.row_axpy(x, i, 0.7)),
                                   atol=1e-5)


def test_kaczmarz_padded_csr_matches_dense(rng):
    """A Kaczmarz solve on the PaddedCSR operator must equal the dense
    solve — the sweep rides the O(k_max) row_dot/row_axpy fast path."""
    m, n = 48, 16
    d = rng.normal(size=(m, n))
    d[rng.uniform(size=d.shape) < 0.6] = 0.0
    x_true = rng.normal(size=(n,))
    b = jnp.asarray(d @ x_true, jnp.float32)
    kw = dict(reg=rt.L2Regularization(1e-4), iterations=15)
    s_dense = rt.Kaczmarz.create(rt.DenseOperator(jnp.asarray(d, jnp.float32)), **kw)
    s_csr = rt.Kaczmarz.create(rt.PaddedCSROperator.from_dense(d.astype(np.float32)), **kw)
    xd = np.asarray(rt.solve(s_dense, b))
    xc = np.asarray(rt.solve(s_csr, b))
    np.testing.assert_allclose(xc, xd, atol=1e-5)
    # randomized precomputed-order mode too (probabilities from rownorms)
    s_dr = rt.Kaczmarz.create(
        rt.DenseOperator(jnp.asarray(d, jnp.float32)), randomized=True,
        sub_matrix_fraction=0.25, precompute_order=True, **kw)
    s_cr = rt.Kaczmarz.create(
        rt.PaddedCSROperator.from_dense(d.astype(np.float32)), randomized=True,
        sub_matrix_fraction=0.25, precompute_order=True, **kw)
    np.testing.assert_allclose(np.asarray(rt.solve(s_cr, b)),
                               np.asarray(rt.solve(s_dr, b)), atol=1e-5)
