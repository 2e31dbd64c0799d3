"""The float64 numpy references (tools/np_reference.py) against the
library's operators and proximal maps, so that a reference bug cannot
hide behind a matching solver bug: forward maps agree, adjoints are
adjoint, proxes agree."""

import jax.numpy as jnp
import numpy as np
import pytest

import rls_tpu as rt
from rls_tpu.models.solvers.pdhg import prox_tv_conj_8dir
from tools import np_reference as ref


def _operators(rng):
    n = 12
    taps = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
    taps /= taps.sum()
    mask = (rng.uniform(size=(n, n)) < 0.4).astype(np.float64)
    maps = rng.normal(size=(3, n, n)) + 1j * rng.normal(size=(3, n, n))
    A = rng.normal(size=(9, 7))
    return {
        "dense": (rt.DenseOperator(jnp.asarray(A, jnp.float32)), ref.Dense(A), 7),
        "sepconv": (rt.SeparableConvOperator.from_taps(taps, taps, (n, n)),
                    ref.SepConv(taps, taps, (n, n)), n * n),
        "subsampled_dft": (rt.SubsampledDFT2RealOperator.from_mask(mask, (n, n)),
                           ref.SubsampledDFT(mask, (n, n)), n * n),
        "sense": (rt.SenseDFT2RealOperator.from_maps(maps.astype(np.complex64), mask,
                                                     (n, n)),
                  ref.Sense(maps, mask, (n, n)), 2 * n * n),
        "gradient_2d": (rt.GradientOperator(im_shape=(n, n), _dtype=jnp.float32),
                        ref.Gradient((n, n)), n * n),
        "gradient_planes": (rt.GradientOperator(im_shape=(2, n, n), dims=(1, 2),
                                                _dtype=jnp.float32),
                            ref.Gradient((2, n, n), (1, 2)), 2 * n * n),
        "grad8": (rt.Grad8Operator(im_shape=(n, n)), ref.Grad8((n, n)), n * n),
    }


@pytest.mark.parametrize("name", ["dense", "sepconv", "subsampled_dft", "sense",
                                  "gradient_2d", "gradient_planes", "grad8"])
def test_reference_operator_matches_library(rng, name):
    op, op64, n = _operators(rng)[name]
    # 5e-5: the compensated operators' 3-term products drop lo·lo, a
    # ~2⁻¹⁶ relative term (the plain f32 products are ~1e-7 here)
    x = rng.normal(size=n)
    y = op64.mv(x)
    np.testing.assert_allclose(np.asarray(op.mv(jnp.asarray(x, jnp.float32))), y,
                               rtol=0, atol=5e-5 * np.abs(y).max())
    w = rng.normal(size=y.shape)
    z = op64.rmv(w)
    np.testing.assert_allclose(np.asarray(op.rmv(jnp.asarray(w, jnp.float32))), z,
                               rtol=0, atol=5e-5 * np.abs(z).max())
    # the reference's own adjoint identity, at f64
    np.testing.assert_allclose(np.vdot(w, y), np.vdot(z, x), rtol=1e-10)


@pytest.mark.parametrize("shape, dims", [((12, 12), None), ((2, 8, 8), (1, 2))])
def test_reference_tv_prox_matches_library(rng, shape, dims):
    x = rng.normal(size=int(np.prod(shape)))
    reg = rt.TVRegularization(0.1, shape=shape, dims=dims, iterations_tv=6)
    got = np.asarray(reg.prox(jnp.asarray(x, jnp.float32)))
    want = ref.tv_prox(shape, dims, 6)(x, 0.1)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_reference_l1_l21_positive_match_library(rng):
    x = rng.normal(size=64)
    xj = jnp.asarray(x, jnp.float32)
    np.testing.assert_allclose(np.asarray(rt.L1Regularization(0.3).prox(xj)),
                               ref.soft_threshold(x, 0.3), atol=1e-6)
    np.testing.assert_allclose(np.asarray(rt.L21Regularization(0.3, slices=2).prox(xj)),
                               ref.l21_prox(2)(x, 0.3), atol=1e-6)
    np.testing.assert_allclose(np.asarray(rt.PositiveRegularization().prox(xj)),
                               ref.positive(x), atol=0)


def test_reference_tv_conj_8dir_matches_library(rng):
    p = rng.normal(size=8 * 36)
    got = np.asarray(prox_tv_conj_8dir(jnp.asarray(p, jnp.float32), 0.4, (6, 6)))
    np.testing.assert_allclose(got, ref.tv_conj_8dir((6, 6))(p, 0.4), atol=1e-6)


def test_reference_svt_blocks_matches_llr(rng):
    img = rng.normal(size=(8, 8, 5))
    reg = rt.LLRRegularization(0.5, shape=(8, 8), block_size=(4, 4), randshift=False)
    got = np.asarray(reg.prox(jnp.asarray(img.reshape(-1), jnp.float32)))
    np.testing.assert_allclose(got, ref.svt_blocks(img, (4, 4), 0.5).reshape(-1),
                               atol=1e-4)


def test_reference_kaczmarz_reaches_least_squares(rng):
    A = rng.normal(size=(40, 8))
    x = rng.normal(size=8)
    got = ref.kaczmarz(A, A @ x, 0.0, [np.arange(40)] * 200)
    np.testing.assert_allclose(got, ref.tikhonov_lstsq(A, A @ x, 0.0), atol=1e-8)


def test_reference_cgnr_solves_normal_equations(rng):
    A = rng.normal(size=(20, 8)) + 3 * np.eye(20, 8)
    b = rng.normal(size=20)
    got = ref.cgnr(ref.Dense(A), b, 0.1, 8, 8)
    np.testing.assert_allclose(got, ref.tikhonov_lstsq(A, b, 0.1), atol=1e-9)
