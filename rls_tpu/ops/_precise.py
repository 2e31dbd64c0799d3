"""f32-accurate matmuls where the matmul unit rounds its inputs — shared
helpers.

Matrix units that round f32 matmul INPUTS to a shorter mantissa (bf16, or
TF32 on GPU tensor cores at XLA's default precision) lose f32 accuracy in
iterated solves. The compensation is an exact hi/lo operand split onto
the bf16 grid plus the cross products; two implementation rules:

1. the split must be done by INTEGER BIT MASKING — an f32→bf16→f32 cast
   round-trip is an identity to the XLA simplifier and gets elided,
   silently disabling the compensation;
2. the three products run as ONE matmul with the constant side
   pre-stacked ``[hi hi lo]`` along the contraction dim and the runtime
   side stacked ``[xh; xl; xh]``.

Used by SeparableConvOperator (conv_direct.py), the split-real DFT /
SENSE operators (dft_real.py), compensated DenseOperator matvecs and the
Jacobi SVD reconstruction. Whether this pays against
``precision=HIGHEST`` on a given device is an open measurement.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

__all__ = [
    "split_bf16",
    "np_split_bf16",
    "stack_left",
    "stack_right",
    "mm_left",
    "mm_right",
    "mm_both",
]


def split_bf16(v):
    """Exact hi/lo split of f32 onto the bf16 grid, by bit masking."""
    vi = lax.bitcast_convert_type(v, jnp.uint32)
    hi = lax.bitcast_convert_type(vi & jnp.uint32(0xFFFF0000), jnp.float32)
    return hi, v - hi


def np_split_bf16(m):
    """Host-side split for precomputing stacked constant factors."""
    import numpy as np

    m32 = np.ascontiguousarray(np.asarray(m, np.float32))
    hi = (m32.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    return hi, m32 - hi


def stack_left(m):
    """(n, 3n) ``[hi hi lo]`` stacking of a constant LEFT factor."""
    import numpy as np

    hi, lo = np_split_bf16(m)
    return np.hstack([hi, hi, lo])


def stack_right(m):
    """(3n, n) ``[hi; hi; lo]`` stacking of a constant RIGHT factor."""
    import numpy as np

    hi, lo = np_split_bf16(m)
    return np.vstack([hi, hi, lo])


def mm_left(l_cat, x):
    """Compensated ``L @ x`` with L pre-stacked by stack_left."""
    xh, xl = split_bf16(x)
    return l_cat @ jnp.concatenate([xh, xl, xh], axis=-2)


def mm_right(x, r_cat):
    """Compensated ``x @ R`` with R pre-stacked by stack_right."""
    xh, xl = split_bf16(x)
    return jnp.concatenate([xh, xl, xh], axis=-1) @ r_cat


def mm_both(a, b):
    """Compensated ``a @ b`` where BOTH operands are runtime values:
    one stacked matmul carrying ALL FOUR products ah·bh + ah·bl + al·bh
    + al·bl. The 3-term form (dropping al·bl, ~2⁻¹⁶ relative per
    multiply) is fine inside self-correcting prox-gradient steps, but
    long Krylov/momentum chains amplify it to ~1e-3 over ~40 iterations,
    so this path carries all four terms.
    Batch dims broadcast like jnp.matmul."""
    ah, al = split_bf16(a)
    bh, bl = split_bf16(b)
    return jnp.concatenate([ah, ah, al, al], axis=-1) @ jnp.concatenate(
        [bh, bl, bh, bl], axis=-2
    )
