"""Finite-difference gradient operator (regTrafo for TV-via-ADMM).

JAX analog of LinearOperatorCollection's ``GradientOp`` used by the
reference for TV (/root/reference/src/proximalMaps/ProxTV.jl:41-46 builds
``∇ = GradientOp(Tc; shape, dims)``; /root/reference/src/ADMM.jl:74 documents
``regTrafo=GradientOp`` for TV penalties).

Forward differences along each requested axis are concatenated:
``y = vcat_d (x[..., 1:, ...] - x[..., :-1, ...])`` — each directional block
has ``(shape[d]-1) * prod(shape[других])`` entries. The adjoint is the
negative divergence (scatter-add of differences). Everything is expressed
with static slicing/padding, so XLA fuses it into surrounding elementwise
work.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from .._pytree import pytree_dataclass, static_field
from .base import LinearOperator

__all__ = ["GradientOperator", "Grad8Operator"]


def _axis_block_size(shape: tuple[int, ...], d: int) -> int:
    n = 1
    for i, s in enumerate(shape):
        n *= (s - 1) if i == d else s
    return n


@pytree_dataclass
class GradientOperator(LinearOperator):
    """Directional forward-difference operator on a flattened image."""

    im_shape: tuple = static_field()
    dims: tuple = static_field(default=None)
    _dtype: Any = static_field(default=jnp.complex64)

    def __post_init__(self):
        if self.dims is None:
            object.__setattr__(self, "dims", tuple(range(len(self.im_shape))))
        elif isinstance(self.dims, int):
            object.__setattr__(self, "dims", (self.dims,))
        else:
            object.__setattr__(self, "dims", tuple(self.dims))

    @property
    def in_size(self) -> int:
        n = 1
        for s in self.im_shape:
            n *= s
        return n

    @property
    def out_size(self) -> int:
        return sum(_axis_block_size(self.im_shape, d) for d in self.dims)

    @property
    def dtype(self):
        return self._dtype

    def mv(self, x):
        im = x.reshape(self.im_shape)
        blocks = []
        for d in self.dims:
            diff = jnp.diff(im, axis=d)
            blocks.append(diff.reshape(-1))
        return jnp.concatenate(blocks)

    def rmv(self, y):
        out = jnp.zeros(self.im_shape, dtype=y.dtype)
        offset = 0
        for d in self.dims:
            bsize = _axis_block_size(self.im_shape, d)
            dshape = tuple(
                (s - 1) if i == d else s for i, s in enumerate(self.im_shape)
            )
            diff = y[offset : offset + bsize].reshape(dshape)
            # adjoint of forward diff: out[..., :-1] -= diff; out[..., 1:] += diff
            pad_lo = [(0, 0)] * len(self.im_shape)
            pad_hi = [(0, 0)] * len(self.im_shape)
            pad_lo[d] = (0, 1)
            pad_hi[d] = (1, 0)
            out = out - jnp.pad(diff, pad_lo) + jnp.pad(diff, pad_hi)
            offset += bsize
        return out.reshape(-1)


@pytree_dataclass
class Grad8Operator(LinearOperator):
    """8-direction finite-difference operator of the reference's
    PrimalDualSolver (`BB`, /root/reference/src/PrimalDualSolver.jl:141-159):
    axial, diagonal, and knight-move differences stacked as 8 (m, n) planes.

    The adjoint is the TRUE linear transpose of the forward map (via
    jax.linear_transpose) rather than a transcription of the reference's
    hand-written divergence `BBS` (:162-198), which skips a handful of
    boundary pixels (e.g. x[2,1:2]); see docs/API_PARITY.md.
    """

    im_shape: tuple = static_field()
    _dtype: Any = static_field(default=jnp.float32)

    def __post_init__(self):
        object.__setattr__(self, "im_shape", tuple(self.im_shape))

    @property
    def in_size(self) -> int:
        m, n = self.im_shape
        return m * n

    @property
    def out_size(self) -> int:
        return 8 * self.in_size

    @property
    def dtype(self):
        return self._dtype

    def mv(self, x):
        m, n = self.im_shape
        u = x.reshape(m, n)
        z = jnp.zeros((m, n), u.dtype)
        # (row-shift, col-shift) of the subtracted sample per direction;
        # zero fill outside each direction's valid region (BB :149-156)
        p1 = z.at[: m - 1, :].set(u[: m - 1, :] - u[1:, :])
        p2 = z.at[:, : n - 1].set(u[:, : n - 1] - u[:, 1:])
        p3 = z.at[: m - 1, : n - 1].set(u[: m - 1, : n - 1] - u[1:, 1:])
        p4 = z.at[: m - 1, 1:].set(u[: m - 1, 1:] - u[1:, : n - 1])
        p5 = z.at[: m - 2, : n - 1].set(u[: m - 2, : n - 1] - u[2:, 1:])
        p6 = z.at[: m - 2, 1:].set(u[: m - 2, 1:] - u[2:, : n - 1])
        p7 = z.at[: m - 1, : n - 2].set(u[: m - 1, : n - 2] - u[1:, 2:])
        p8 = z.at[: m - 1, 2:].set(u[: m - 1, 2:] - u[1:, : n - 2])
        return jnp.concatenate(
            [p.reshape(-1) for p in (p1, p2, p3, p4, p5, p6, p7, p8)]
        )

    def rmv(self, y):
        import jax

        primal = jnp.zeros((self.in_size,), y.dtype)
        (out,) = jax.linear_transpose(self.mv, primal)(y)
        return out
