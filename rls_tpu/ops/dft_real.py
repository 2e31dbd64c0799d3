"""Subsampled 2-D DFT and multi-coil SENSE as REAL split re/im matmuls.

Runtimes without FFT/complex support cannot run `SubsampledFFTOperator`.
The operators here pose the same `A = S∘F` / `A = stack_c(S∘F∘C_c)`
measurement models of the compressed-sensing and multi-coil MRI
configurations entirely in real f32:

  * the unitary 2-D DFT `F X Fᵀ` is evaluated with the real and imaginary
    parts of the (symmetric!) 1-D DFT matrix as dense matmul
    sandwiches — `C = (Fr+iFi)(Xr+iXi)(Fr+iFi)ᵀ` expands into real
    products;
  * sampling is a static binary mask in the frequency plane (no
    gather/scatter, shapes stay static);
  * measurements stack `[re; im]` — the standard real form of a complex
    least-squares system, so every solver runs unchanged in f32;
  * ``normal`` is fused (mask between the two sandwiches);
  * every constant factor is applied with stacked hi/lo compensation
    (ops/_precise.py), so the products hold f32 accuracy where the
    matmul unit rounds its inputs — which matters once CG/FISTA iterate
    on the operator.

Complex L1 regularization of the split vector is `L21Regularization(λ,
slices=2)`: the group ℓ2 over (re, im) pairs IS the complex magnitude
soft-threshold (reference ProxL1.jl:18-22).

Reference counterpart: the sampled-DFT products used by the CS examples
(/root/reference/docs/src/literate/examples/compressed_sensing.jl) and the
multi-coil stacked operators used by MRIReco.jl (docs/src/index.md:7); the
split-real evaluation itself has no Julia analog.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from .._pytree import pytree_dataclass, static_field
from ._precise import mm_left, mm_right, stack_left, stack_right
from .base import LinearOperator

__all__ = ["SubsampledDFT2RealOperator", "SenseDFT2RealOperator"]


def _dft_factors(n: int, dtype=None):
    import numpy as np

    dtype = np.float32 if dtype is None else np.dtype(dtype)
    k = np.arange(n)
    w = np.exp(-2j * np.pi * np.outer(k, k) / n) / np.sqrt(n)  # unitary
    # the DFT matrix is SYMMETRIC (w[j,k] == w[k,j]), so left- and
    # right-/transposed applications share the same factors
    return w.real.astype(dtype), w.imag.astype(dtype)


def _dft_cat(h: int, w: int):
    """Pre-stacked hi/lo compensation factors for both axes."""
    fr_h, fi_h = _dft_factors(h)
    fr_w, fi_w = _dft_factors(w)
    return {
        "l_fr": jnp.asarray(stack_left(fr_h)),
        "l_fi": jnp.asarray(stack_left(fi_h)),
        "r_fr": jnp.asarray(stack_right(fr_w)),
        "r_fi": jnp.asarray(stack_right(fi_w)),
    }


class _DFTRealBase(LinearOperator):
    """Shared split-real DFT machinery (factors + compensated multiplies)."""

    def _comp(self):
        # backend-independent (see conv_direct._comp): compensation is an
        # operator property so CPU-traced programs run the device program
        return self.compensated and self.cat is not None

    # left-multiply by F factor along H; right-multiply along W (F == Fᵀ)
    def _lm(self, which, x):
        if self._comp():
            return mm_left(self.cat["l_" + which], x)
        return (self.fr_h if which == "fr" else self.fi_h) @ x

    def _rm(self, x, which):
        if self._comp():
            return mm_right(x, self.cat["r_" + which])
        return x @ (self.fr_w if which == "fr" else self.fi_w)

    def _cfwd(self, xr, xi):
        """F X Fᵀ of X = xr + i·xi; leading batch axes broadcast."""
        lr = self._lm("fr", xr) - self._lm("fi", xi)
        li = self._lm("fr", xi) + self._lm("fi", xr)
        cr = self._rm(lr, "fr") - self._rm(li, "fi")
        ci = self._rm(lr, "fi") + self._rm(li, "fr")
        return cr, ci

    def _cadj(self, cr, ci):
        """Adjoint of _cfwd: Fᴴ C F̄ (both split components); Fᵀ == F."""
        lr = self._lm("fr", cr) + self._lm("fi", ci)
        li = self._lm("fr", ci) - self._lm("fi", cr)
        xr = self._rm(lr, "fr") + self._rm(li, "fi")
        xi = self._rm(li, "fr") - self._rm(lr, "fi")
        return xr, xi


@pytree_dataclass
class SubsampledDFT2RealOperator(_DFTRealBase):
    """Real-valued subsampled unitary 2-D DFT on a REAL (H, W) image.

    in: flat real image (H*W,) — out: stacked real/imag samples (2*H*W,)
    with zeros at unsampled frequencies (mask form keeps shapes static).
    """

    fr_h: Any  # (H, H) Re(F_H)
    fi_h: Any  # (H, H) Im(F_H)
    fr_w: Any
    fi_w: Any
    mask: Any  # (H, W) f32 binary sampling mask
    cat: Any  # pre-stacked compensation factors (None when disabled)
    im_shape: tuple = static_field()
    compensated: bool = static_field(default=True)

    def __post_init__(self):
        object.__setattr__(self, "im_shape", tuple(self.im_shape))

    @classmethod
    def from_mask(cls, mask, im_shape, compensated=True, dtype=jnp.float32):
        h, w = im_shape
        dtype = jnp.dtype(dtype)
        if dtype != jnp.float32:
            compensated = False  # the hi/lo split is f32-specific
        fr_h, fi_h = _dft_factors(h, dtype)
        fr_w, fi_w = _dft_factors(w, dtype)
        return cls(
            fr_h=jnp.asarray(fr_h),
            fi_h=jnp.asarray(fi_h),
            fr_w=jnp.asarray(fr_w),
            fi_w=jnp.asarray(fi_w),
            mask=jnp.asarray(mask, dtype).reshape(h, w),
            cat=_dft_cat(h, w) if compensated else None,
            im_shape=(h, w),
            compensated=compensated,
        )

    @classmethod
    def from_sample_idx(cls, sample_idx, im_shape, compensated=True,
                        dtype=jnp.float32):
        """Same sampling convention as SubsampledFFTOperator: int indices
        into the flattened (row-major) frequency plane."""
        h, w = im_shape
        m = jnp.zeros((h * w,), dtype).at[jnp.asarray(sample_idx)].set(1.0)
        return cls.from_mask(m.reshape(h, w), im_shape, compensated, dtype)

    @property
    def in_size(self) -> int:
        h, w = self.im_shape
        return h * w

    @property
    def out_size(self) -> int:
        return 2 * self.in_size

    @property
    def dtype(self):
        return self.fr_h.dtype

    def mv(self, x):
        h, w = self.im_shape
        xr = x.reshape(h, w)
        cr, ci = self._cfwd(xr, jnp.zeros_like(xr))
        return jnp.concatenate(
            [(cr * self.mask).reshape(-1), (ci * self.mask).reshape(-1)]
        )

    def rmv(self, y):
        h, w = self.im_shape
        n = h * w
        cr = (y[:n].reshape(h, w)) * self.mask
        ci = (y[n:].reshape(h, w)) * self.mask
        xr, _ = self._cadj(cr, ci)
        return xr.reshape(-1)

    def normal(self, x):
        h, w = self.im_shape
        xr = x.reshape(h, w)
        cr, ci = self._cfwd(xr, jnp.zeros_like(xr))
        out, _ = self._cadj(cr * self.mask, ci * self.mask)
        return out.reshape(-1)


@pytree_dataclass
class SenseDFT2RealOperator(_DFTRealBase):
    """Multi-coil SENSE MRI operator `A = stack_c (M ∘ F ∘ C_c)` in split
    real/imaginary form — complex image, coil maps, and k-space, all f32.

    A complex image x ∈ ℂ^{HW} is the flat real vector [xr; xi] (2HW,);
    each coil multiplies by its complex sensitivity map elementwise, the
    DFT runs as real matmul sandwiches, sampling is a static mask, and
    measurements stack as (C, 2, H, W) → flat — the multi-coil MRI
    measurement model without FFT or complex dtypes.
    """

    fr_h: Any
    fi_h: Any
    fr_w: Any
    fi_w: Any
    coils_r: Any  # (C, H, W)
    coils_i: Any  # (C, H, W)
    mask: Any  # (H, W)
    cat: Any
    im_shape: tuple = static_field()
    compensated: bool = static_field(default=True)

    def __post_init__(self):
        object.__setattr__(self, "im_shape", tuple(self.im_shape))

    @classmethod
    def from_maps(cls, coil_maps, mask, im_shape, compensated=True,
                  dtype=jnp.float32):
        """coil_maps: complex (C, H, W) ndarray; mask: (H, W) binary."""
        import numpy as np

        h, w = im_shape
        dtype = jnp.dtype(dtype)
        if dtype != jnp.float32:
            compensated = False  # the hi/lo split is f32-specific
        fr_h, fi_h = _dft_factors(h, dtype)
        fr_w, fi_w = _dft_factors(w, dtype)
        cm = np.asarray(coil_maps)
        return cls(
            fr_h=jnp.asarray(fr_h),
            fi_h=jnp.asarray(fi_h),
            fr_w=jnp.asarray(fr_w),
            fi_w=jnp.asarray(fi_w),
            coils_r=jnp.asarray(cm.real, dtype),
            coils_i=jnp.asarray(cm.imag, dtype),
            mask=jnp.asarray(mask, dtype).reshape(h, w),
            cat=_dft_cat(h, w) if compensated else None,
            im_shape=(h, w),
            compensated=compensated,
        )

    @property
    def n_coils(self) -> int:
        return self.coils_r.shape[0]

    @property
    def in_size(self) -> int:
        h, w = self.im_shape
        return 2 * h * w

    @property
    def out_size(self) -> int:
        h, w = self.im_shape
        return 2 * self.n_coils * h * w

    @property
    def dtype(self):
        return self.fr_h.dtype

    def _split_x(self, x):
        h, w = self.im_shape
        n = h * w
        return x[:n].reshape(h, w), x[n:].reshape(h, w)

    def _coil_mul(self, xr, xi):
        ur = self.coils_r * xr - self.coils_i * xi
        ui = self.coils_r * xi + self.coils_i * xr
        return ur, ui

    def _coil_adj_sum(self, ur, ui):
        xr = jnp.sum(self.coils_r * ur + self.coils_i * ui, axis=0)
        xi = jnp.sum(self.coils_r * ui - self.coils_i * ur, axis=0)
        return xr, xi

    def mv(self, x):
        ur, ui = self._coil_mul(*self._split_x(x))
        kr, ki = self._cfwd(ur, ui)
        out = jnp.stack([kr * self.mask, ki * self.mask], axis=1)  # (C,2,H,W)
        return out.reshape(-1)

    def rmv(self, y):
        h, w = self.im_shape
        k = y.reshape(self.n_coils, 2, h, w)
        ur, ui = self._cadj(k[:, 0] * self.mask, k[:, 1] * self.mask)
        xr, xi = self._coil_adj_sum(ur, ui)
        return jnp.concatenate([xr.reshape(-1), xi.reshape(-1)])

    def normal(self, x):
        ur, ui = self._coil_mul(*self._split_x(x))
        kr, ki = self._cfwd(ur, ui)
        vr, vi = self._cadj(kr * self.mask, ki * self.mask)
        xr, xi = self._coil_adj_sum(vr, vi)
        return jnp.concatenate([xr.reshape(-1), xi.reshape(-1)])
