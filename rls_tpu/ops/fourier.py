"""FFT-based operators: subsampled Fourier (compressed sensing) and
circular convolution (deblurring).

Reference analogs: ``SamplingOp * DFTOp`` products from
LinearOperatorCollection used in the reference's CS test problem
(/root/reference/test/testSolvers.jl:67-125) and FFT-based normal-operator
optimization (`docs/src/literate/howto/normal_operator.jl`). Design: the *normal* operators are fused into a single
FFT → diagonal multiply → IFFT pipeline (no gather/scatter), which is the
dominant cost of every proximal-gradient iteration and maps onto XLA's
batched FFT + fused elementwise.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from .._pytree import pytree_dataclass, static_field
from .base import LinearOperator

__all__ = ["SubsampledFFTOperator", "FFTOperator", "ConvolutionOperator"]


@pytree_dataclass
class FFTOperator(LinearOperator):
    """Unitary (ortho-normalized) n-D FFT on a flattened image."""

    im_shape: tuple = static_field()

    @property
    def in_size(self) -> int:
        n = 1
        for s in self.im_shape:
            n *= s
        return n

    @property
    def out_size(self) -> int:
        return self.in_size

    @property
    def dtype(self):
        return jnp.complex64

    def mv(self, x):
        return jnp.fft.fftn(x.reshape(self.im_shape), norm="ortho").reshape(-1)

    def rmv(self, y):
        return jnp.fft.ifftn(y.reshape(self.im_shape), norm="ortho").reshape(-1)

    def normal(self, x):
        return x  # unitary


@pytree_dataclass
class SubsampledFFTOperator(LinearOperator):
    """``A = S ∘ F``: unitary FFT followed by sampling of `sample_idx`.

    ``normal(x) = Fᴴ Sᵀ S F x`` is fused as FFT → binary mask → IFFT —
    no gather/scatter on the hot path.
    """

    sample_idx: Any  # int32 indices into the flattened frequency domain
    im_shape: tuple = static_field()

    @property
    def in_size(self) -> int:
        n = 1
        for s in self.im_shape:
            n *= s
        return n

    @property
    def out_size(self) -> int:
        return self.sample_idx.shape[0]

    @property
    def dtype(self):
        return jnp.complex64

    def _mask(self):
        m = jnp.zeros((self.in_size,), dtype=jnp.float32)
        return m.at[self.sample_idx].set(1.0)

    def mv(self, x):
        k = jnp.fft.fftn(x.reshape(self.im_shape), norm="ortho").reshape(-1)
        return k[self.sample_idx]

    def rmv(self, y):
        k = jnp.zeros((self.in_size,), dtype=y.dtype).at[self.sample_idx].set(y)
        return jnp.fft.ifftn(k.reshape(self.im_shape), norm="ortho").reshape(-1)

    def normal(self, x):
        k = jnp.fft.fftn(x.reshape(self.im_shape), norm="ortho")
        k = k * self._mask().reshape(self.im_shape)
        return jnp.fft.ifftn(k, norm="ortho").reshape(-1)


@pytree_dataclass
class ConvolutionOperator(LinearOperator):
    """Circular convolution with a PSF given by its OTF (frequency response).

    ``mv = ifft(otf · fft(x))``, ``normal = ifft(|otf|² · fft(x))`` — the
    |OTF|² fusion is the classic deblurring normal-op trick the reference
    documents in its normal-operator how-to.
    """

    otf: Any  # complex frequency response, shape == im_shape
    im_shape: tuple = static_field()

    @classmethod
    def from_kernel(cls, kernel, im_shape):
        """Build from a spatial kernel (zero-padded, centered at index 0)."""
        pad = jnp.zeros(im_shape, dtype=jnp.complex64)
        sl = tuple(slice(0, k) for k in kernel.shape)
        pad = pad.at[sl].set(kernel.astype(jnp.complex64))
        # center the kernel at the origin for symmetric blurs
        shifts = tuple(-(k // 2) for k in kernel.shape)
        pad = jnp.roll(pad, shifts, axis=tuple(range(len(im_shape))))
        otf = jnp.fft.fftn(pad)
        return cls(otf=otf, im_shape=tuple(im_shape))

    @property
    def in_size(self) -> int:
        n = 1
        for s in self.im_shape:
            n *= s
        return n

    @property
    def out_size(self) -> int:
        return self.in_size

    @property
    def dtype(self):
        return jnp.complex64

    def mv(self, x):
        k = jnp.fft.fftn(x.reshape(self.im_shape))
        return jnp.fft.ifftn(self.otf * k).reshape(-1)

    def rmv(self, y):
        k = jnp.fft.fftn(y.reshape(self.im_shape))
        return jnp.fft.ifftn(jnp.conj(self.otf) * k).reshape(-1)

    def normal(self, x):
        k = jnp.fft.fftn(x.reshape(self.im_shape))
        k = (jnp.abs(self.otf) ** 2) * k
        return jnp.fft.ifftn(k).reshape(-1)
