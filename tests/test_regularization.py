"""Regularization decorators, mirroring /root/reference/test/testRegularization.jl:
scaled/fixed/auto decorators, masked and transformed terms, PnP defaults and
solver compatibility, λ-clipping, sink resolution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rls_tpu as rt
from rls_tpu import solve
from rls_tpu.models.regularization import find_sink, find_sinks, sink


def test_sink_and_find(rng):
    l1 = rt.L1Regularization(0.5)
    scaled = rt.FixedScaledRegularization(l1, 2.0)
    norm = rt.NormalizedRegularization(scaled, 3.0)
    assert sink(norm) is l1
    regs = [norm, rt.L2Regularization(0.1), rt.PositiveRegularization()]
    assert find_sink(rt.L1Regularization, regs) == 0
    assert find_sinks(rt.models.regularization.ParameterizedRegularization, regs) == [0, 1]
    assert float(norm.get_lam()) == pytest.approx(3.0)  # 0.5*2*3


def test_fixed_scaled_prox(rng):
    x = jnp.asarray(rng.normal(size=(16,)), jnp.float32)
    l1 = rt.L1Regularization(0.2)
    scaled = rt.FixedScaledRegularization(l1, 2.0)
    np.testing.assert_allclose(
        np.asarray(scaled.prox(x)), np.asarray(l1.prox(x, 0.4)), atol=1e-6
    )


def test_fixed_parameter_ignores_incoming_lambda(rng):
    x = jnp.asarray(rng.normal(size=(16,)), jnp.float32)
    l1 = rt.L1Regularization(0.2)
    fixed = rt.FixedParameterRegularization(l1)
    np.testing.assert_allclose(
        np.asarray(fixed.prox(x, 99.0)), np.asarray(l1.prox(x, 0.2)), atol=1e-6
    )


def test_auto_scaled(rng):
    x = jnp.asarray(rng.normal(size=(16,)), jnp.float32)
    l1 = rt.L1Regularization(0.1)
    auto = rt.AutoScaledRegularization(l1)
    expected = l1.prox(x, 0.1 * float(jnp.max(jnp.abs(x))))
    np.testing.assert_allclose(np.asarray(auto.prox(x)), np.asarray(expected), atol=1e-6)


def test_auto_scaled_latched(rng):
    """Latched mode pins the reference's first-call factor
    (ScaledRegularization.jl:63-71): later calls with DIFFERENT iterates
    keep the original scale, unlike the recompute default."""
    x0 = jnp.asarray(rng.normal(size=(16,)), jnp.float32)
    x1 = 3.0 * x0
    l1 = rt.L1Regularization(0.1)
    latched = rt.AutoScaledRegularization(l1).latched(x0)
    f0 = float(jnp.max(jnp.abs(x0)))
    want = l1.prox(x1, 0.1 * f0)
    np.testing.assert_allclose(
        np.asarray(latched.prox(x1)), np.asarray(want), atol=1e-6
    )
    # λ accessor includes the latched factor, like the reference's λ(reg)
    np.testing.assert_allclose(float(latched.get_lam()), 0.1 * f0, rtol=1e-6)
    # recompute default would use max|x1| instead
    auto = rt.AutoScaledRegularization(l1)
    assert not np.allclose(np.asarray(auto.prox(x1)), np.asarray(want))


def test_masked_regularization(rng):
    x = -jnp.ones((4,), jnp.float32)
    masked = rt.MaskedRegularization(
        rt.PositiveRegularization(), mask=[True, False, True, False]
    )
    out = np.asarray(masked.prox(x))
    np.testing.assert_allclose(out, [0.0, -1.0, 0.0, -1.0])


def test_transformed_regularization(rng):
    """Soft-threshold in the FFT domain of a unitary transform."""
    n = 16
    trafo = rt.FFTOperator(im_shape=(n,))
    x = jnp.asarray(
        (rng.normal(size=(n,)) + 1j * rng.normal(size=(n,))).astype(np.complex64)
    )
    reg = rt.TransformedRegularization(rt.L1Regularization(0.1), trafo)
    out = reg.prox(x, 0.1)
    expected = trafo.rmv(rt.L1Regularization(0.1).prox(trafo.mv(x), 0.1))
    np.testing.assert_allclose(np.asarray(out), np.asarray(expected), atol=1e-5)


def test_pnp_regularization(rng):
    """PnP with a toy 'denoiser' (identity → prox is identity; shrink model)."""
    x = jnp.asarray(rng.normal(size=(16,)), jnp.float32)
    pnp = rt.PnPRegularization(
        1.0, model=lambda v: v, shape=(16,), input_transform=rt.models.regularization.IdentityTransform
    )
    np.testing.assert_allclose(np.asarray(pnp.prox(x, 0.5)), np.asarray(x), atol=1e-6)

    # complex input: real/imag parts denoised separately
    xc = (x + 1j * x).astype(jnp.complex64)
    out = pnp.prox(xc, 0.5)
    np.testing.assert_allclose(np.asarray(out), np.asarray(xc), atol=1e-6)

    # λ clipped to [0, 1]
    shrink = rt.PnPRegularization(
        1.0, model=lambda v: 0.5 * v, shape=(16,),
        input_transform=rt.models.regularization.IdentityTransform,
    )
    out5 = shrink.prox(x, 5.0)  # behaves like λ=1
    out1 = shrink.prox(x, 1.0)
    np.testing.assert_allclose(np.asarray(out5), np.asarray(out1), atol=1e-6)


def test_pnp_in_solver(rng):
    """PnP works inside ADMM / FISTA (testRegularization.jl:22-39)."""
    A = jnp.asarray(rng.normal(size=(8, 6)).astype(np.float32))
    xt = jnp.asarray(np.abs(rng.normal(size=(6,))).astype(np.float32))
    b = A @ xt
    pnp = rt.PnPRegularization(
        0.1, model=lambda v: v, shape=(6,),
        input_transform=rt.models.regularization.IdentityTransform,
    )
    s = rt.ADMM.create(A, reg=pnp, iterations=30)
    x = solve(s, b)
    err = float(jnp.linalg.norm(x - xt) / jnp.linalg.norm(xt))
    assert err < 0.1


def test_input_transforms(rng):
    x = jnp.asarray(rng.normal(size=(32,)), jnp.float32)
    for T in [
        rt.models.regularization.MinMaxTransform,
        rt.models.regularization.ZTransform,
        rt.models.regularization.IdentityTransform,
    ]:
        tf = T(x)
        np.testing.assert_allclose(
            np.asarray(tf.backward(tf.forward(x))), np.asarray(x), atol=1e-5
        )
    tf = rt.models.regularization.ClampedScalingTransform(x, -1.0, 1.0)
    rec = tf.backward(tf.forward(x))
    np.testing.assert_allclose(np.asarray(rec), np.asarray(x), atol=1e-5)


def test_normalization_factors(rng):
    A = rt.DenseOperator(jnp.asarray(rng.normal(size=(6, 4)).astype(np.float32)))
    b = jnp.asarray(rng.normal(size=(6,)).astype(np.float32))
    from rls_tpu.models.regularization import normalization_factor

    f0 = float(normalization_factor(rt.NoNormalization(), A, b))
    assert f0 == 1.0
    f1 = float(normalization_factor(rt.MeasurementBasedNormalization(), A, b))
    assert f1 == pytest.approx(float(jnp.sum(jnp.abs(b)) / 6), rel=1e-5)
    f2 = float(normalization_factor(rt.SystemMatrixBasedNormalization(), A, b))
    assert f2 == pytest.approx(float(jnp.sum(A.row_norms_sq()) / 4), rel=1e-5)
    with pytest.raises(ValueError):
        normalization_factor(rt.SystemMatrixBasedNormalization(), None, b)


def test_pnp_trained_cnn_denoiser_end_to_end(rng):
    """PnP-ADMM with a genuinely TRAINED tiny CNN denoiser (DnCNN-style
    residual net, optax-trained on synthetic phantoms) must beat the
    unregularized recon on a noisy deblurring problem — the end-to-end
    learned-prior path of the reference how-to
    (docs/src/literate/howto/plug-and-play.jl), f32 throughout."""
    from rls_tpu.models.denoisers import make_pnp_model, train_denoiser
    from rls_tpu.models.regularization import IdentityTransform

    n = 32
    params = train_denoiser(n, channels=6, steps=150, noise_sigma=0.08, seed=0)

    g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
    kern = np.outer(g, g)
    kern /= kern.sum()
    op = rt.SeparableConvOperator.from_kernel(kern, im_shape=(n, n))
    img = np.zeros((n, n), np.float32)
    img[6:10, 4:20] = 0.7
    img[14:28, 10:22] = 0.4
    x_true = jnp.asarray(img.reshape(-1))
    b = op.mv(x_true) + 0.02 * jnp.asarray(
        rng.normal(size=(n * n,)), jnp.float32
    )

    pnp = rt.PnPRegularization(
        0.3, model=make_pnp_model(params), shape=(n * n,),
        input_transform=IdentityTransform,
    )
    s_pnp = rt.ADMM.create(op, reg=pnp, iterations=25, iterations_cg=6,
                           rho=0.5)
    s_l2 = rt.CGNR.create(op, reg=rt.L2Regularization(1e-6), iterations=12)
    x_pnp = np.asarray(jax.jit(rt.solve)(s_pnp, b))
    x_l2 = np.asarray(jax.jit(rt.solve)(s_l2, b))
    nrm = np.linalg.norm(np.asarray(x_true))
    err_pnp = np.linalg.norm(x_pnp - np.asarray(x_true)) / nrm
    err_l2 = np.linalg.norm(x_l2 - np.asarray(x_true)) / nrm
    assert np.isfinite(x_pnp).all()
    assert err_pnp < err_l2, (err_pnp, err_l2)
    assert err_pnp < 0.25, err_pnp


def test_pnp_lambda_clamp_warns():
    """Reference warns when PnP λ is clipped to [0,1]
    (PlugAndPlayRegularization.jl:47-51) — mirrored eagerly at ctor."""
    with pytest.warns(UserWarning, match="clipped"):
        rt.PnPRegularization(1.5, model=lambda x: x, shape=(4,))
    import warnings as _w

    with _w.catch_warnings():
        _w.simplefilter("error")
        rt.PnPRegularization(0.5, model=lambda x: x, shape=(4,))
