"""Orthogonal discrete wavelet transform operator (sparsifying transform).

JAX analog of the ``WaveletOp`` (LinearOperatorCollection /
Wavelets.jl) that the reference's documentation nests regularization terms
around: /root/reference/docs/src/literate/explanations/regularization.jl:50-88
builds ``TransformedRegularization(L1Regularization(λ), WaveletOp(...))`` to
soft-threshold in the wavelet domain. The reference itself only consumes the
operator through the generic ``regTrafo`` seam
(/root/reference/src/Regularization/TransformedRegularization.jl); this module
provides the operator so that workflow is available here too.

Design:
* Periodized orthogonal DWT (Haar / Daubechies) on 1-D or 2-D signals. The
  per-axis analysis step ``y[k] = Σ_j f[j] · x[(2k+j) mod n]`` is expressed
  as ``L`` static ``jnp.roll``s + one stride-2 slice — pure gather/elementwise
  work that XLA fuses; no FFT and no complex intermediates.
* Orthogonality makes the adjoint the exact inverse; ``rmv`` is the written
  transpose (zero-upsample + opposite-direction rolls), so ``rmv∘mv ≈ id`` to
  float round-off and the operator is safe as a ``TransformedRegularization``
  / sparsifying ``regTrafo`` transform.
* Multi-level transforms recurse on the low(-low) band with the standard
  packed quadrant layout (approximation in the top-left corner), matching
  Wavelets.jl's in-place ``dwt`` layout.
* The filters are real, so the map is ℂ-linear and complex inputs transform
  componentwise for free.

All shapes/levels are static metadata — the Python level recursion unrolls at
trace time into a fixed fused program.
"""

from __future__ import annotations

import math
from typing import Any

import jax.numpy as jnp

from .._pytree import pytree_dataclass, static_field
from .base import LinearOperator

__all__ = ["WaveletOperator", "WAVELET_FILTERS"]


# Orthonormal scaling (low-pass analysis) filters. High-pass follows from the
# quadrature-mirror relation g[j] = (-1)^j h[L-1-j].
_SQRT2 = math.sqrt(2.0)
_SQRT3 = math.sqrt(3.0)
WAVELET_FILTERS: dict[str, tuple[float, ...]] = {
    "haar": (1.0 / _SQRT2, 1.0 / _SQRT2),
    "db2": (
        (1.0 + _SQRT3) / (4.0 * _SQRT2),
        (3.0 + _SQRT3) / (4.0 * _SQRT2),
        (3.0 - _SQRT3) / (4.0 * _SQRT2),
        (1.0 - _SQRT3) / (4.0 * _SQRT2),
    ),
    "db4": (
        0.23037781330885523,
        0.7148465705525415,
        0.6308807679295904,
        -0.02798376941698385,
        -0.18703481171888114,
        0.030841381835986965,
        0.032883011666982945,
        -0.010597401784997278,
    ),
    # Longer families used by the reference docs' Wavelets.jl workflow
    # (wavelet(WT.db6) etc. in docs/src/literate/explanations/
    # regularization.jl). Tap tables in the same h0-first orientation as
    # db4 above; all verified to satisfy Σh = √2, ‖h‖ = 1 and
    # Σ_j h[j]h[j+2k] = δ_k to <1e-12 (tests/test_operators.py).
    "db6": (
        0.11154074335008017,
        0.4946238903983854,
        0.7511339080215775,
        0.3152503517092432,
        -0.22626469396516913,
        -0.12976686756709563,
        0.09750160558707936,
        0.02752286553001629,
        -0.031582039318031156,
        0.0005538422009938016,
        0.004777257511010651,
        -0.001077301085308479,
    ),
    "db8": (
        0.05441584224308161,
        0.31287159091446592,
        0.67563073629801285,
        0.58535468365486909,
        -0.01582910525602,
        -0.28401554296242809,
        0.00047248457399797254,
        0.128747426620186,
        -0.01736930100202211,
        -0.044088253931064719,
        0.013981027917015516,
        0.0087460940470156547,
        -0.0048703529930106603,
        -0.00039174037299597711,
        0.00067544940599855677,
        -0.00011747678400228192,
    ),
    # Symlet-4: Daubechies-4 moments with near-linear phase.
    "sym4": (
        0.0322231006040427,
        -0.012603967262037833,
        -0.09921954357684722,
        0.29785779560527736,
        0.8037387518059161,
        0.49761866763201545,
        -0.02963552764599851,
        -0.07576571478927333,
    ),
}
WAVELET_FILTERS["db1"] = WAVELET_FILTERS["haar"]


def _qmf(h: tuple[float, ...]) -> tuple[float, ...]:
    L = len(h)
    return tuple(((-1.0) ** j) * h[L - 1 - j] for j in range(L))


def _analysis(x, h, g, axis):
    """One periodized analysis step along ``axis`` → (low, high) bands."""
    acc_lo = h[0] * x
    acc_hi = g[0] * x
    for j in range(1, len(h)):
        xs = jnp.roll(x, -j, axis=axis)
        acc_lo = acc_lo + h[j] * xs
        acc_hi = acc_hi + g[j] * xs
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(0, None, 2)
    sl = tuple(sl)
    return acc_lo[sl], acc_hi[sl]


def _synthesis(lo, hi, h, g, axis):
    """Transpose of :func:`_analysis` (== inverse, by orthogonality)."""
    shape = list(lo.shape)
    shape[axis] = 2 * shape[axis]
    sl = [slice(None)] * lo.ndim
    sl[axis] = slice(0, None, 2)
    sl = tuple(sl)
    u_lo = jnp.zeros(shape, dtype=lo.dtype).at[sl].set(lo)
    u_hi = jnp.zeros(shape, dtype=hi.dtype).at[sl].set(hi)
    acc = h[0] * u_lo + g[0] * u_hi
    for j in range(1, len(h)):
        acc = acc + h[j] * jnp.roll(u_lo, j, axis=axis)
        acc = acc + g[j] * jnp.roll(u_hi, j, axis=axis)
    return acc


def max_wavelet_levels(im_shape: tuple[int, ...], wavelet: str = "db2") -> int:
    """Deepest usable level count: every dim must stay even and at least as
    long as the filter at each level (Wavelets.jl ``maxtransformlevels``
    analog, tightened by the filter length for the periodized transform)."""
    L = len(WAVELET_FILTERS[wavelet])
    lev = 0
    dims = list(im_shape)
    while all(d % 2 == 0 and d >= max(L, 2) for d in dims):
        lev += 1
        dims = [d // 2 for d in dims]
    return lev


@pytree_dataclass
class WaveletOperator(LinearOperator):
    """Orthogonal periodized DWT on a flattened 1-D/2-D signal.

    ``mv`` = analysis (image → packed coefficients), ``rmv`` = synthesis
    (= exact inverse). ``normal`` is the identity, which XLA sees as a no-op.
    """

    im_shape: tuple = static_field()
    wavelet: str = static_field(default="db2")
    levels: int = static_field(default=None)
    _dtype: Any = static_field(default=jnp.float32)

    def __post_init__(self):
        if isinstance(self.im_shape, int):
            object.__setattr__(self, "im_shape", (self.im_shape,))
        else:
            object.__setattr__(self, "im_shape", tuple(self.im_shape))
        if self.wavelet not in WAVELET_FILTERS:
            raise ValueError(
                f"unknown wavelet {self.wavelet!r}; "
                f"available: {sorted(WAVELET_FILTERS)}"
            )
        if len(self.im_shape) not in (1, 2):
            raise ValueError(
                "WaveletOperator supports 1-D and 2-D signals, got shape "
                f"{self.im_shape}"
            )
        if self.levels is None:
            object.__setattr__(
                self, "levels", max_wavelet_levels(self.im_shape, self.wavelet)
            )
        if self.levels < 1:
            raise ValueError("levels must be >= 1")
        L = len(WAVELET_FILTERS[self.wavelet])
        for d in self.im_shape:
            if d % (1 << self.levels):
                raise ValueError(
                    f"dim {d} not divisible by 2^levels = {1 << self.levels}"
                )
            if (d >> (self.levels - 1)) < max(L, 2):
                raise ValueError(
                    f"dim {d} too short for {self.levels} levels of "
                    f"{self.wavelet!r} (filter length {L})"
                )

    # --- protocol ---------------------------------------------------------
    @property
    def in_size(self) -> int:
        n = 1
        for s in self.im_shape:
            n *= s
        return n

    out_size = in_size

    @property
    def dtype(self):
        return self._dtype

    def _filters(self):
        h = WAVELET_FILTERS[self.wavelet]
        return h, _qmf(h)

    def _fwd(self, im, level):
        if level == 0:
            return im
        h, g = self._filters()
        if im.ndim == 1:
            lo, hi = _analysis(im, h, g, 0)
            return jnp.concatenate([self._fwd(lo, level - 1), hi])
        lo0, hi0 = _analysis(im, h, g, 0)
        ll, lh = _analysis(lo0, h, g, 1)
        hl, hh = _analysis(hi0, h, g, 1)
        top = jnp.concatenate([self._fwd(ll, level - 1), lh], axis=1)
        bot = jnp.concatenate([hl, hh], axis=1)
        return jnp.concatenate([top, bot], axis=0)

    def _inv(self, c, level):
        if level == 0:
            return c
        h, g = self._filters()
        if c.ndim == 1:
            n2 = c.shape[0] // 2
            lo = self._inv(c[:n2], level - 1)
            return _synthesis(lo, c[n2:], h, g, 0)
        H2, W2 = c.shape[0] // 2, c.shape[1] // 2
        ll = self._inv(c[:H2, :W2], level - 1)
        lo0 = _synthesis(ll, c[:H2, W2:], h, g, 1)
        hi0 = _synthesis(c[H2:, :W2], c[H2:, W2:], h, g, 1)
        return _synthesis(lo0, hi0, h, g, 0)

    def mv(self, x):
        return self._fwd(x.reshape(self.im_shape), self.levels).reshape(-1)

    def rmv(self, y):
        return self._inv(y.reshape(self.im_shape), self.levels).reshape(-1)

    def normal(self, x):
        # WᴴW = I exactly for orthogonal filters.
        return x
