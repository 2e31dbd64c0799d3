"""Operator protocol tests: adjointness <Ax, y> == <x, Aᴴy>, normal-op
consistency, row access. (Reference has no dedicated operator tests — it
relies on LinearOperators.jl — but our operators are new code.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rls_tpu as rt


def _adjoint_check(op, rng, tol=1e-4):
    x = jnp.asarray(
        rng.normal(size=(op.in_size,)) + 1j * rng.normal(size=(op.in_size,)),
        dtype=op.dtype if jnp.issubdtype(op.dtype, jnp.complexfloating) else None,
    )
    if not jnp.issubdtype(op.dtype, jnp.complexfloating):
        x = jnp.asarray(rng.normal(size=(op.in_size,)), jnp.float32)
    y = (
        jnp.asarray(
            rng.normal(size=(op.out_size,)) + 1j * rng.normal(size=(op.out_size,))
        ).astype(op.dtype)
        if jnp.issubdtype(op.dtype, jnp.complexfloating)
        else jnp.asarray(rng.normal(size=(op.out_size,)), jnp.float32)
    )
    lhs = jnp.vdot(y, op.mv(x))
    rhs = jnp.vdot(op.rmv(y), x)
    assert abs(lhs - rhs) < tol * (abs(lhs) + 1)
    # normal consistency
    nx = op.normal(x)
    ref = op.rmv(op.mv(x))
    np.testing.assert_allclose(np.asarray(nx), np.asarray(ref), atol=1e-4)


def test_dense_adjoint(rng):
    mat = jnp.asarray(
        (rng.normal(size=(12, 8)) + 1j * rng.normal(size=(12, 8))).astype(
            np.complex64
        )
    )
    _adjoint_check(rt.DenseOperator(mat), rng)


def test_gradient_op_adjoint(rng):
    op = rt.GradientOperator(im_shape=(5, 7), _dtype=jnp.float32)
    _adjoint_check(op, rng)
    op2 = rt.GradientOperator(im_shape=(4, 6, 3), dims=(0, 2), _dtype=jnp.complex64)
    _adjoint_check(op2, rng)


def test_gradient_op_matches_diff(rng):
    op = rt.GradientOperator(im_shape=(4, 5), _dtype=jnp.float32)
    img = jnp.asarray(rng.normal(size=(4, 5)), jnp.float32)
    g = op.mv(img.reshape(-1))
    expected = jnp.concatenate(
        [jnp.diff(img, axis=0).reshape(-1), jnp.diff(img, axis=1).reshape(-1)]
    )
    np.testing.assert_allclose(np.asarray(g), np.asarray(expected), rtol=1e-6)


def test_subsampled_fft_adjoint(rng):
    n = 16 * 16
    idx = jnp.asarray(sorted(rng.choice(n, size=n // 3, replace=False)), jnp.int32)
    op = rt.SubsampledFFTOperator(sample_idx=idx, im_shape=(16, 16))
    _adjoint_check(op, rng)


def test_convolution_adjoint(rng):
    kern = jnp.asarray(rng.normal(size=(3, 3)), jnp.float32)
    op = rt.ConvolutionOperator.from_kernel(kern, (12, 12))
    _adjoint_check(op, rng)


def test_weighting_prod_stack(rng):
    mat = jnp.asarray(rng.normal(size=(6, 4)), jnp.float32)
    w = jnp.asarray(rng.uniform(0.5, 1.5, size=(6,)), jnp.float32)
    prod = rt.ProdOperator(rt.WeightingOperator(w), rt.DenseOperator(mat))
    dense = rt.DenseOperator(w[:, None] * mat)
    x = jnp.asarray(rng.normal(size=(4,)), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(prod.mv(x)), np.asarray(dense.mv(x)), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(prod.row(2)), np.asarray(dense.row(2)), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(prod.row_norms_sq()), np.asarray(dense.row_norms_sq()), rtol=1e-5
    )
    stack = rt.StackedOperator(ops=(rt.DenseOperator(mat), rt.DenseOperator(2 * mat)))
    np.testing.assert_allclose(
        np.asarray(stack.mv(x)),
        np.concatenate([np.asarray(mat @ x), np.asarray(2 * mat @ x)]),
        rtol=1e-5,
    )
    _adjoint_check(stack, rng)


def test_sparse_operator(rng):
    dense = rng.normal(size=(10, 6))
    dense[rng.uniform(size=(10, 6)) < 0.6] = 0.0
    op = rt.SparseOperator.from_dense(dense.astype(np.float32))
    x = jnp.asarray(rng.normal(size=(6,)), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(op.mv(x)), dense.astype(np.float32) @ np.asarray(x), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(op.row(3)), dense[3].astype(np.float32), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(op.row_norms_sq()),
        (np.abs(dense) ** 2).sum(1).astype(np.float32),
        rtol=1e-5,
    )


def test_power_iterations(rng):
    mat = jnp.asarray(rng.normal(size=(20, 20)), jnp.float32)
    aha = rt.NormalOperator(rt.DenseOperator(mat))
    lam = float(rt.power_iterations(aha))
    true = float(np.linalg.eigvalsh(np.asarray(mat).T @ np.asarray(mat)).max())
    assert abs(lam - true) / true < 2e-2


def test_separable_conv_matches_direct(rng):
    """SeparableConvOperator ≡ DirectConvOperator for a rank-1 kernel —
    mv/rmv/normal all agree to f32 roundoff, boundaries included."""
    n = 32
    g = np.exp(-((np.arange(7) - 3) ** 2) / 4.0)
    kern = np.outer(g, g)
    kern /= kern.sum()
    direct = rt.DirectConvOperator(
        kernel=jnp.asarray(kern, jnp.float32), im_shape=(n, n)
    )
    sep = rt.SeparableConvOperator.from_kernel(kern, im_shape=(n, n))
    x = jnp.asarray(rng.normal(size=(n * n,)), jnp.float32)
    y = jnp.asarray(rng.normal(size=(n * n,)), jnp.float32)
    for name in ("mv", "rmv", "normal"):
        a = np.asarray(getattr(direct, name)(x))
        b = np.asarray(getattr(sep, name)(x))
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
    _adjoint_check(sep, rng)
    # fused normal == rmv∘mv
    np.testing.assert_allclose(
        np.asarray(sep.normal(x)),
        np.asarray(sep.rmv(sep.mv(x))),
        rtol=0,
        atol=2e-5,
    )
    # vdot adjoint identity directly
    lhs = np.vdot(np.asarray(y), np.asarray(sep.mv(x)))
    rhs = np.vdot(np.asarray(sep.rmv(y)), np.asarray(x))
    assert abs(lhs - rhs) < 1e-3


def test_separable_conv_rejects_nonseparable():
    kern = np.eye(5, dtype=np.float32)  # rank 5
    with pytest.raises(ValueError):
        rt.SeparableConvOperator.from_kernel(kern, im_shape=(16, 16))


def test_stacked_bf16_compensation_helpers(rng):
    """The stacked single-matmul compensation (the production path inside
    SeparableConvOperator/DFT operators) must recover near-f64 accuracy."""
    from rls_tpu.ops._precise import mm_left, mm_right, stack_left, stack_right

    a64 = rng.normal(size=(24, 24))
    b64 = rng.normal(size=(24, 24))
    x = jnp.asarray(b64, jnp.float32)
    got_l = np.asarray(mm_left(jnp.asarray(stack_left(a64)), x))
    got_r = np.asarray(mm_right(x, jnp.asarray(stack_right(b64.T))))
    ref_l = a64 @ b64
    ref_r = b64 @ b64.T
    # hi/lo split drops only the lo@lo term: ~ (2^-8)^2 relative
    assert np.abs(got_l - ref_l).max() / np.abs(ref_l).max() < 5e-4
    assert np.abs(got_r - ref_r).max() / np.abs(ref_r).max() < 5e-4


def test_power_iterations_subdominant_start():
    """Regression: with a start vector nearly orthogonal to the dominant
    eigenvector, the rtol test must not stop early on the SUBDOMINANT
    eigenvalue (that underestimates λmax and makes the 0.95/λmax FISTA
    default step divergent — observed as a full-suite nan flake)."""
    # the exact matrix from the flake (eigs ≈ 1.257, 2.249); PRNGKey(0)'s
    # 2-vector happens to nearly align with the subdominant eigenvector
    aha = np.array(
        [[1.8667651, -0.48323855], [-0.48323855, 1.6397696]], np.float32
    )
    lam = float(rt.power_iterations(rt.DenseOperator(jnp.asarray(aha))))
    true = float(np.linalg.eigvalsh(aha).max())
    assert abs(lam - true) / true < 1e-2, (lam, true)


def test_subsampled_dft_real_matches_complex_fft(rng):
    """SubsampledDFT2RealOperator (real split re/im matmul form) must agree
    with SubsampledFFTOperator for real images: same normal op, adjoint
    consistency, and matching measurements."""
    h = w = 16
    n = h * w
    idx = jnp.asarray(sorted(rng.choice(n, size=n // 3, replace=False)), jnp.int32)
    op_c = rt.SubsampledFFTOperator(sample_idx=idx, im_shape=(h, w))
    op_r = rt.SubsampledDFT2RealOperator.from_sample_idx(idx, (h, w))
    x = jnp.asarray(rng.normal(size=(n,)), jnp.float32)

    # measurements: gathered complex vs masked stacked real
    yc = np.asarray(op_c.mv(x.astype(jnp.complex64)))
    yr = np.asarray(op_r.mv(x))
    cr = yr[:n][np.asarray(idx)]
    ci = yr[n:][np.asarray(idx)]
    # 5e-5: the compensated stacked matmul (the same program on every
    # backend) differs from the complex FFT at the f32 floor
    np.testing.assert_allclose(cr, yc.real, atol=5e-5)
    np.testing.assert_allclose(ci, yc.imag, atol=5e-5)

    # fused normal: real part of the complex normal
    nc = np.asarray(op_c.normal(x.astype(jnp.complex64)))
    nr = np.asarray(op_r.normal(x))
    np.testing.assert_allclose(nr, nc.real, atol=5e-5)

    # adjoint identity <y, Ax> == <A^T y, x>
    y = jnp.asarray(rng.normal(size=(op_r.out_size,)), jnp.float32)
    lhs = float(jnp.vdot(y, op_r.mv(x)))
    rhs = float(jnp.vdot(op_r.rmv(y), x))
    assert abs(lhs - rhs) < 1e-3 * (abs(lhs) + 1)
    # normal == rmv∘mv
    np.testing.assert_allclose(
        np.asarray(op_r.normal(x)), np.asarray(op_r.rmv(op_r.mv(x))), atol=5e-5
    )


def test_sense_dft_real_matches_complex(rng):
    """SenseDFT2RealOperator ≡ the complex multi-coil model
    mask∘fft2(coil_c·x) computed with jnp complex FFTs, for a complex
    image carried as [re; im]."""
    h = w = 12
    n = h * w
    C = 3
    maps = (rng.normal(size=(C, h, w)) + 1j * rng.normal(size=(C, h, w))).astype(
        np.complex64
    )
    mask = (rng.uniform(size=(h, w)) < 0.4).astype(np.float32)
    op = rt.SenseDFT2RealOperator.from_maps(maps, mask, (h, w))
    xc = (rng.normal(size=(h, w)) + 1j * rng.normal(size=(h, w))).astype(
        np.complex64
    )
    x = jnp.concatenate(
        [jnp.asarray(xc.real).reshape(-1), jnp.asarray(xc.imag).reshape(-1)]
    )

    y = np.asarray(op.mv(x)).reshape(C, 2, h, w)
    for c in range(C):
        ref = mask * np.fft.fft2(maps[c] * xc, norm="ortho")
        # 2e-4: compensated stacked matmul vs complex FFT at the f32 floor
        np.testing.assert_allclose(y[c, 0], ref.real, atol=2e-4)
        np.testing.assert_allclose(y[c, 1], ref.imag, atol=2e-4)

    # adjoint identity and fused normal
    yv = jnp.asarray(rng.normal(size=(op.out_size,)), jnp.float32)
    lhs = float(jnp.vdot(yv, op.mv(x)))
    rhs = float(jnp.vdot(op.rmv(yv), x))
    assert abs(lhs - rhs) < 1e-3 * (abs(lhs) + 1)
    np.testing.assert_allclose(
        np.asarray(op.normal(x)), np.asarray(op.rmv(op.mv(x))), atol=1e-4
    )


def test_sense_dft_real_unitary_full_mask(rng):
    """Full sampling + unit coil ⇒ AᴴA = identity (unitary DFT)."""
    h = w = 8
    op = rt.SenseDFT2RealOperator.from_maps(
        np.ones((1, h, w), np.complex64), np.ones((h, w), np.float32), (h, w)
    )
    x = jnp.asarray(rng.normal(size=(2 * h * w,)), jnp.float32)
    np.testing.assert_allclose(np.asarray(op.normal(x)), np.asarray(x), atol=1e-5)


def test_dense_operator_compensated(rng):
    """compensated=True must agree with the plain path on an f32-native
    backend (it is the same math, reassociated) and pass complex inputs
    through uncompensated."""
    A = rng.normal(size=(12, 8)).astype(np.float32)
    op_p = rt.DenseOperator(jnp.asarray(A))
    op_c = rt.DenseOperator(jnp.asarray(A), compensated=True)
    x = jnp.asarray(rng.normal(size=(8,)), jnp.float32)
    y = jnp.asarray(rng.normal(size=(12,)), jnp.float32)
    # f32-floor tolerance: the hi/lo reassociation drops the lo*lo term
    np.testing.assert_allclose(
        np.asarray(op_c.mv(x)), np.asarray(op_p.mv(x)), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(
        np.asarray(op_c.rmv(y)), np.asarray(op_p.rmv(y)), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(
        np.asarray(op_c.normal(x)), np.asarray(op_p.normal(x)), rtol=2e-4,
        atol=2e-5)
    xc = jnp.asarray(rng.normal(size=(8,)) + 1j * rng.normal(size=(8,)),
                     jnp.complex64)
    out = np.asarray(op_c.mv(xc))
    assert out.dtype == np.complex64 and np.isfinite(out).all()


# --------------------------------------------------------------------------
# WaveletOperator (ops/wavelet.py) — reference docs' WaveletOp analog
# (docs/src/literate/explanations/regularization.jl:50-88)
# --------------------------------------------------------------------------


def test_wavelet_filter_tables_orthonormal():
    """Every shipped tap table must satisfy the orthonormal-QMF
    conditions exactly: Σh = √2, ‖h‖² = 1, Σ_j h[j]h[j+2k] = 0."""
    from rls_tpu.ops.wavelet import WAVELET_FILTERS

    for name, h in WAVELET_FILTERS.items():
        h = np.asarray(h, np.float64)
        assert abs(h.sum() - np.sqrt(2.0)) < 1e-10, name
        assert abs((h * h).sum() - 1.0) < 1e-10, name
        for k in range(1, len(h) // 2):
            assert abs((h[: -2 * k] * h[2 * k:]).sum()) < 1e-10, (name, k)


@pytest.mark.parametrize(
    "wavelet", ["haar", "db2", "db4", "db6", "db8", "sym4"])
@pytest.mark.parametrize("shape", [(64,), (16, 32)])
def test_wavelet_perfect_reconstruction(rng, wavelet, shape):
    op = rt.WaveletOperator(shape, wavelet=wavelet)
    assert op.levels >= 1
    x = jnp.asarray(rng.normal(size=(op.in_size,)), jnp.float32)
    y = op.mv(x)
    # orthogonal: energy preserved and adjoint == inverse
    np.testing.assert_allclose(
        float(jnp.vdot(y, y).real), float(jnp.vdot(x, x).real), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(op.rmv(y)), np.asarray(x), atol=1e-5)
    _adjoint_check(op, rng)


def test_wavelet_dense_orthogonal(rng):
    op = rt.WaveletOperator((16, 16), wavelet="db2", levels=2)
    W = np.asarray(op.to_dense())
    np.testing.assert_allclose(W.T @ W, np.eye(256), atol=1e-5)


def test_wavelet_haar_constant_packs_top_left():
    lev = 3
    op = rt.WaveletOperator((32, 32), wavelet="haar", levels=lev)
    c = 0.7
    y = np.asarray(op.mv(jnp.full((32 * 32,), c, jnp.float32)))
    y = y.reshape(32, 32)
    n = 32 >> lev
    # approximation band = c * 2^lev (per axis √2 gain), details exactly 0
    np.testing.assert_allclose(y[:n, :n], c * (2.0**lev), rtol=1e-5)
    assert np.max(np.abs(y[n:, :])) < 1e-5 and np.max(np.abs(y[:n, n:])) < 1e-5


def test_wavelet_complex_componentwise(rng):
    op = rt.WaveletOperator((32,), wavelet="db2", _dtype=jnp.complex64)
    re = jnp.asarray(rng.normal(size=(32,)), jnp.float32)
    im = jnp.asarray(rng.normal(size=(32,)), jnp.float32)
    yc = np.asarray(op.mv(re + 1j * im))
    np.testing.assert_allclose(yc.real, np.asarray(op.mv(re)), atol=1e-6)
    np.testing.assert_allclose(yc.imag, np.asarray(op.mv(im)), atol=1e-6)


def test_wavelet_validation_errors():
    with pytest.raises(ValueError, match="unknown wavelet"):
        rt.WaveletOperator((32,), wavelet="sym9")
    with pytest.raises(ValueError, match="divisible"):
        rt.WaveletOperator((24,), wavelet="haar", levels=4)
    with pytest.raises(ValueError, match="too short"):
        rt.WaveletOperator((16,), wavelet="db4", levels=3)
    with pytest.raises(ValueError, match="1-D and 2-D"):
        rt.WaveletOperator((4, 4, 4), wavelet="haar")
    # 64 → 32 → 16 → 8 → 4: five levels; the 5th-level input length equals
    # the db2 filter length (4), the shortest valid periodized signal
    assert rt.max_wavelet_levels((64, 64), "db2") == 5


def test_wavelet_transformed_l1_prox(rng):
    """TransformedRegularization(L1, W) == Wᴴ soft(Wx) — the reference
    docs' wavelet-domain soft-thresholding workflow."""
    op = rt.WaveletOperator((16, 16), wavelet="db2")
    reg = rt.TransformedRegularization(rt.L1Regularization(0.1), op)
    x = jnp.asarray(rng.normal(size=(256,)), jnp.float32)
    got = np.asarray(reg.prox(x))
    from rls_tpu.models.prox import soft_threshold

    want = np.asarray(op.rmv(soft_threshold(op.mv(x), 0.1)))
    np.testing.assert_allclose(got, want, atol=1e-6)
