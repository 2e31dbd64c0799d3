"""Tiny pure-jnp CNN denoiser for plug-and-play priors.

The reference's PnP how-to plugs a pre-trained network into
PlugAndPlayRegularization (docs/src/literate/howto/plug-and-play.jl,
src/Regularization/PlugAndPlayRegularization.jl:17-55). This module
provides the JAX equivalent end to end: a 3-layer residual CNN
(`cnn_denoise`) in plain `lax.conv_general_dilated` calls — no framework
dependency, f32, accelerator-runnable — plus `train_denoiser`, which actually
trains it (noise2clean MSE on synthetic piecewise-constant images, optax
Adam) so examples/tests exercise a *learned* prior rather than a
hand-rolled smoother. A flax/haiku `apply` closure drops in identically.

Architecture: 3×3 conv (1→C) → relu → 3×3 conv (C→C) → relu →
3×3 conv (C→1), residual: `denoise(x) = x − net(x)` (the net predicts the
noise, DnCNN-style).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["init_cnn_params", "cnn_denoise", "train_denoiser", "make_pnp_model"]


def init_cnn_params(key, channels: int = 8):
    """He-initialized weights for the 3-layer residual CNN."""
    k1, k2, k3 = jax.random.split(key, 3)

    def he(k, shape, fan_in):
        return jax.random.normal(k, shape, jnp.float32) * np.sqrt(2.0 / fan_in)

    return {
        "w1": he(k1, (channels, 1, 3, 3), 9),
        "b1": jnp.zeros((channels,), jnp.float32),
        "w2": he(k2, (channels, channels, 3, 3), 9 * channels),
        "b2": jnp.zeros((channels,), jnp.float32),
        "w3": he(k3, (1, channels, 3, 3), 9 * channels),
        "b3": jnp.zeros((1,), jnp.float32),
    }


def _conv(x, w, b):
    # x: (N, C_in, H, W), w: (C_out, C_in, 3, 3) — SAME padding
    out = lax.conv_general_dilated(
        x, w, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    return out + b[None, :, None, None]


def cnn_denoise(params, img):
    """Residual denoise of a single (H, W) image (or flat vector with a
    square length): `x − net(x)`."""
    shp = img.shape
    if img.ndim == 1:
        n = int(round(np.sqrt(img.shape[0])))
        img = img.reshape(n, n)
    x = img[None, None, :, :]
    h = jax.nn.relu(_conv(x, params["w1"], params["b1"]))
    h = jax.nn.relu(_conv(h, params["w2"], params["b2"]))
    noise = _conv(h, params["w3"], params["b3"])
    return (x - noise)[0, 0].reshape(shp)


def _phantom_batch(rng, n, batch):
    imgs = np.zeros((batch, n, n), np.float32)
    for b in range(batch):
        for _ in range(5):
            i0, j0 = rng.integers(0, n - n // 4, size=2)
            w, h = rng.integers(n // 8, n // 3, size=2)
            imgs[b, i0 : i0 + w, j0 : j0 + h] += rng.uniform(0.2, 0.8)
    return np.clip(imgs, 0.0, 1.0)


def train_denoiser(
    n: int,
    channels: int = 8,
    steps: int = 200,
    noise_sigma: float = 0.1,
    batch: int = 8,
    seed: int = 0,
    lr: float = 2e-3,
):
    """Train the CNN on synthetic piecewise-constant phantoms + gaussian
    noise (MSE, Adam). Returns trained params. Seconds on CPU — meant for
    self-contained examples/tests; swap in a real training set for
    production priors."""
    import optax

    rng = np.random.default_rng(seed)
    params = init_cnn_params(jax.random.PRNGKey(seed), channels)
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    def loss_fn(p, noisy, clean):
        out = jax.vmap(lambda im: cnn_denoise(p, im))(noisy)
        return jnp.mean((out - clean) ** 2)

    @jax.jit
    def train_step(p, s, noisy, clean):
        l, g = jax.value_and_grad(loss_fn)(p, noisy, clean)
        updates, s = opt.update(g, s, p)
        return optax.apply_updates(p, updates), s, l

    for _ in range(steps):
        clean = _phantom_batch(rng, n, batch)
        noisy = clean + rng.normal(0, noise_sigma, clean.shape).astype(
            np.float32
        )
        params, opt_state, _ = train_step(
            params, opt_state, jnp.asarray(noisy), jnp.asarray(clean)
        )
    return params


def make_pnp_model(params):
    """Wrap trained params as the array→array callable
    PlugAndPlayRegularization expects."""
    return lambda x: cnn_denoise(params, x)
