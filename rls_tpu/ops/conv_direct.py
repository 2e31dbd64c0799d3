"""Direct (non-FFT) convolution operator via lax.conv_general_dilated.

Complement to the FFT-based ConvolutionOperator (fourier.py) for small
kernels. SAME zero padding; adjoint = correlation with the flipped
conjugate kernel (exact for odd kernel sizes).

Reference analog: the image-deblurring convolution operators of the
reference's examples.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp
from jax import lax

from .._pytree import pytree_dataclass, static_field
from .base import LinearOperator

__all__ = ["DirectConvOperator", "SeparableConvOperator"]


def _conv2d_same(img, kern):
    # img: (H, W) real; kern: (kh, kw)
    out = lax.conv_general_dilated(
        img[None, None],
        kern[None, None],
        window_strides=(1, 1),
        padding="SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    return out[0, 0]


@pytree_dataclass
class DirectConvOperator(LinearOperator):
    """2-D SAME-padded convolution on a flattened real image."""

    kernel: Any  # (kh, kw), odd sizes recommended
    im_shape: tuple = static_field()

    def __post_init__(self):
        object.__setattr__(self, "im_shape", tuple(self.im_shape))

    @property
    def in_size(self) -> int:
        h, w = self.im_shape
        return h * w

    @property
    def out_size(self) -> int:
        return self.in_size

    @property
    def dtype(self):
        return self.kernel.dtype

    def mv(self, x):
        img = x.reshape(self.im_shape)
        return _conv2d_same(img, self.kernel).reshape(-1)

    def rmv(self, y):
        img = y.reshape(self.im_shape)
        k_adj = jnp.flip(jnp.conj(self.kernel), axis=(0, 1))
        return _conv2d_same(img, k_adj).reshape(-1)

    def normal(self, x):
        # autocorrelation kernel k ⋆ k applied once; with SAME padding this
        # matches rmv(mv(x)) away from the boundary — use the exact two-conv
        # form to keep adjoint consistency at edges.
        return self.rmv(self.mv(x))


# --------------------------------------------------------------------------
# Separable (banded-matmul) convolution
# --------------------------------------------------------------------------


def _banded(n: int, taps) -> "Any":
    """Dense (n, n) matrix of SAME zero-padded 1-D convolution with `taps`
    (odd length). Built on host in float64 so the normal-op factors below
    are exact to f32 roundoff."""
    import numpy as np

    taps = np.asarray(taps, np.float64)
    k = taps.shape[0]
    m = np.zeros((n, n), np.float64)
    for i, t in enumerate(taps):
        off = i - k // 2
        m += np.diag(np.full(n - abs(off), float(t), np.float64), k=off)
    return m


# shared bf16-compensation helpers (see ops/_precise.py for the why)
from ._precise import (  # noqa: E402
    split_bf16 as _split_bf16,
    stack_left as _stack_left,
    stack_right as _stack_right,
)


@pytree_dataclass
class SeparableConvOperator(LinearOperator):
    """2-D SAME zero-padded convolution with a separable (rank-1) kernel
    ``k = outer(taps_h, taps_w)``, evaluated as two banded matrix products
    ``Y = A_h X A_wᵀ``.

    Rationale: a single-channel spatial conv has a contraction dim of 1,
    so it cannot use a matrix unit; the banded form turns each 1-D pass
    into a dense (N×N)·(N×N) matmul, and the fused ``normal`` applies the
    precomputed Gram factors ``B = AᵀA`` (built in f64 on host) in a
    single pass: ``AᴴA X = B_h X B_wᵀ`` — the reference's
    fused-normal-operator idea (docs/literate/howto/normal_operator.jl:37-60)
    in matmul form. The banded products do ~N/k times the arithmetic of a
    k-tap stencil; which form is faster on a given device is an open
    measurement.

    Semantically identical (to f32 roundoff) to ``DirectConvOperator`` with
    ``kernel=outer(taps_h, taps_w)``: SAME zero padding factorizes exactly
    into two zero-padded 1-D passes, boundaries included.

    ``compensated=True`` (default) applies bf16 hi/lo error compensation
    (ops/_precise.py) to every product, so the operator holds f32
    accuracy where matmul inputs are rounded below f32. Real dtypes only
    (the compensation split has no complex bf16).
    """

    ah: Any  # (H, H) banded column-pass factor
    aw: Any  # (W, W) banded row-pass factor
    bh: Any  # ahᵀ ah, host-precomputed in f64
    bw: Any  # awᵀ aw
    # pre-stacked [hi hi lo] compensation factors (None when compensated=False)
    cat: Any  # dict: {"mv": (L, R), "rmv": (L, R), "normal": (L, R)}
    im_shape: tuple = static_field()
    compensated: bool = static_field(default=True)

    def __post_init__(self):
        object.__setattr__(self, "im_shape", tuple(self.im_shape))

    @classmethod
    def from_taps(cls, taps_h, taps_w, im_shape, dtype=jnp.float32, compensated=True):
        h, w = im_shape
        a_h = _banded(h, taps_h)
        a_w = _banded(w, taps_w)
        b_h = a_h.T @ a_h
        b_w = a_w.T @ a_w
        cat = None
        if compensated and dtype == jnp.float32:
            cat = {
                name: (
                    jnp.asarray(_stack_left(left)),
                    jnp.asarray(_stack_right(right)),
                )
                for name, left, right in [
                    ("mv", a_h, a_w.T),
                    ("rmv", a_h.T, a_w),
                    ("normal", b_h, b_w.T),
                ]
            }
        return cls(
            ah=jnp.asarray(a_h, dtype),
            aw=jnp.asarray(a_w, dtype),
            bh=jnp.asarray(b_h, dtype),
            bw=jnp.asarray(b_w, dtype),
            cat=cat,
            im_shape=(h, w),
            compensated=compensated,
        )

    @classmethod
    def from_kernel(cls, kernel, im_shape, dtype=jnp.float32, compensated=True,
                    rank_tol=1e-6):
        """Factor a 2-D kernel via SVD; requires numerical rank 1."""
        import numpy as np

        k = np.asarray(kernel, np.float64)
        u, s, vt = np.linalg.svd(k)
        if s.shape[0] > 1 and s[1] > rank_tol * s[0]:
            raise ValueError(
                f"kernel is not separable (σ2/σ1 = {s[1]/s[0]:.2e}); "
                "use DirectConvOperator"
            )
        taps_h = u[:, 0] * np.sqrt(s[0])
        taps_w = vt[0] * np.sqrt(s[0])
        # fix sign so the dominant tap is positive (pure convention)
        if taps_h[len(taps_h) // 2] < 0:
            taps_h, taps_w = -taps_h, -taps_w
        return cls.from_taps(taps_h, taps_w, im_shape, dtype, compensated)

    @property
    def in_size(self) -> int:
        h, w = self.im_shape
        return h * w

    @property
    def out_size(self) -> int:
        return self.in_size

    @property
    def dtype(self):
        return self.ah.dtype

    def _comp(self):
        # depends only on the operator config (never the trace-time
        # backend), so the CPU suite exercises the exact program that runs
        # on the accelerator. Where matmuls are f32-exact the compensated
        # form is redundant but equally accurate.
        return self.compensated and self.ah.dtype == jnp.float32

    def _sandwich(self, x, left, right_t, name):
        img = x.reshape(self.im_shape)
        if not (self._comp() and self.cat is not None):
            return (left @ img @ right_t).reshape(x.shape)
        # single-matmul hi/lo compensation per side: the constant factor is
        # pre-stacked [hi hi lo] along the contraction dim, the runtime
        # operand is stacked [xh; xl; xh], so one (n,3n)·(3n,n) product
        # carries all three compensation terms (see _stack_left)
        l_cat, r_cat = self.cat[name]
        xh, xl = _split_bf16(img)
        m = l_cat @ jnp.concatenate([xh, xl, xh], axis=-2)
        mh, ml = _split_bf16(m)
        out = jnp.concatenate([mh, ml, mh], axis=-1) @ r_cat
        return out.reshape(x.shape)

    def mv(self, x):
        return self._sandwich(x, self.ah, self.aw.T, "mv")

    def rmv(self, y):
        return self._sandwich(y, self.ah.T, self.aw, "rmv")

    def normal(self, x):
        return self._sandwich(x, self.bh, self.bw.T, "normal")
