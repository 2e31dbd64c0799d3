"""Matrix-free linear operator protocol and core implementations.

JAX counterpart of the reference's L0 operator layer
(LinearOperators.jl / LinearOperatorCollection.jl usage, see
/root/reference/src/RegularizedLeastSquares.jl:14-16 and SURVEY.md §1 L0).
Operators are frozen pytrees: array payloads (the dense matrix, FFT masks,
weights) are traced leaves, shapes are static metadata, and every method is
pure, so operators compose freely under `jit`/`vmap`/`shard_map`.

Protocol (duck-typed; all vectors are flat 1-D complex/real arrays):
  * ``mv(x)``     — ``A @ x``               (reference: ``mul!(y, A, x)``)
  * ``rmv(y)``    — ``Aᴴ @ y``              (reference: ``mul!(x, A', y)``)
  * ``normal(x)`` — ``Aᴴ A x`` fused where algebraically reducible
  * ``in_size`` / ``out_size`` — static sizes
  * row-action extras (Kaczmarz): ``row(i)``, ``row_norms_sq()``
    mirroring ``dot_with_matrix_row`` / ``rownorm²``
    (/root/reference/src/Utils.jl:6-105).
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .._pytree import pytree_dataclass, static_field

__all__ = [
    "LinearOperator",
    "DenseOperator",
    "IdentityOperator",
    "WeightingOperator",
    "ProdOperator",
    "NormalOperator",
    "StackedOperator",
    "SamplingOperator",
    "as_operator",
    "adjoint_operator",
]


class LinearOperator:
    """Base class (protocol) for matrix-free linear operators."""

    # --- required ---
    @property
    def in_size(self) -> int:
        raise NotImplementedError

    @property
    def out_size(self) -> int:
        raise NotImplementedError

    def mv(self, x):
        raise NotImplementedError

    def rmv(self, y):
        raise NotImplementedError

    # --- default implementations ---
    def normal(self, x):
        """AᴴA x — override for fused versions (|OTF|², FᴴMᵀMF, …)."""
        return self.rmv(self.mv(x))

    @property
    def shape(self) -> tuple[int, int]:
        return (self.out_size, self.in_size)

    @property
    def dtype(self):
        raise NotImplementedError

    # --- row action protocol (override where cheap) ---
    def row(self, i):
        """i-th row of A as a dense vector (for row-action solvers)."""
        raise NotImplementedError(f"{type(self).__name__} has no row access")

    def row_norms_sq(self):
        """Vector of squared 2-norms of the rows (reference: rownorm²)."""
        raise NotImplementedError(f"{type(self).__name__} has no row access")

    def row_dot(self, i, x):
        """τ = a_i · x, UNconjugated (reference ``dot_with_matrix_row``,
        /root/reference/src/Utils.jl:96-105). Default goes through the
        dense ``row``; sparse operators override with an O(nnz_row)
        gather."""
        return jnp.sum(self.row(i) * x)

    def row_axpy(self, x, i, alpha):
        """x + α·conj(a_i) (reference ``kaczmarz_update!``,
        /root/reference/src/Kaczmarz.jl:532-539). Default dense axpy;
        sparse operators override with an O(nnz_row) scatter-add."""
        return x + alpha * jnp.conj(self.row(i))

    def to_dense(self):
        """Materialize as a dense matrix (small operators / direct solvers)."""
        eye = jnp.eye(self.in_size, dtype=self.dtype)
        return jax.vmap(self.mv, in_axes=1, out_axes=1)(eye)

    # operator algebra sugar
    def __matmul__(self, other):
        if isinstance(other, LinearOperator):
            return ProdOperator(self, other)
        return self.mv(other)

    @property
    def H(self) -> "LinearOperator":
        return adjoint_operator(self)


@pytree_dataclass
class DenseOperator(LinearOperator):
    """Dense matrix operator. The workhorse for small/medium A; matvecs map
    straight onto the device's matmul units. Reference analog: plain ``Matrix`` system matrices.

    The plain products are pinned to ``precision=HIGHEST``: at XLA's
    default precision an H100 rounds f32 matmul inputs to TF32, which
    puts dense CGNR ~5e-4 off its float64 solution. ``compensated=True``
    instead applies the stacked hi/lo bf16 compensation
    (ops/_precise.mm_both) to every matvec (real f32 matrices only).
    """

    mat: Any
    compensated: bool = static_field(default=False)

    def _comp(self) -> bool:
        return self.compensated and self.mat.dtype == jnp.float32

    @property
    def in_size(self) -> int:
        return self.mat.shape[1]

    @property
    def out_size(self) -> int:
        return self.mat.shape[0]

    @property
    def dtype(self):
        return self.mat.dtype

    def _mm(self, a, x):
        if self._comp() and not jnp.issubdtype(x.dtype, jnp.complexfloating):
            from ._precise import mm_both

            return mm_both(a, x[..., None])[..., 0]
        return jnp.matmul(a, x, precision=lax.Precision.HIGHEST)

    def mv(self, x):
        return self._mm(self.mat, x)

    def rmv(self, y):
        return self._mm(self.mat.conj().T, y)

    def normal(self, x):
        return self.rmv(self.mv(x))

    def row(self, i):
        return self.mat[i]

    def row_norms_sq(self):
        return jnp.sum(jnp.abs(self.mat) ** 2, axis=1)

    def to_dense(self):
        return self.mat


@pytree_dataclass
class IdentityOperator(LinearOperator):
    """opEye analog (/root/reference/src/ADMM.jl:84)."""

    n: int = static_field()
    _dtype: Any = static_field(default=jnp.complex64)

    @property
    def in_size(self) -> int:
        return self.n

    @property
    def out_size(self) -> int:
        return self.n

    @property
    def dtype(self):
        return self._dtype

    def mv(self, x):
        return x

    def rmv(self, y):
        return y

    def normal(self, x):
        return x

    def row(self, i):
        n = self.n
        return (jnp.arange(n) == i).astype(self._dtype)

    def row_norms_sq(self):
        return jnp.ones((self.n,), dtype=jnp.float32)


@pytree_dataclass
class WeightingOperator(LinearOperator):
    """Diagonal weighting, reference ``WeightingOp``."""

    weights: Any

    @property
    def in_size(self) -> int:
        return self.weights.shape[0]

    @property
    def out_size(self) -> int:
        return self.weights.shape[0]

    @property
    def dtype(self):
        return self.weights.dtype

    def mv(self, x):
        return self.weights * x

    def rmv(self, y):
        return jnp.conj(self.weights) * y

    def normal(self, x):
        return jnp.abs(self.weights) ** 2 * x

    def row(self, i):
        n = self.in_size
        return jnp.where(jnp.arange(n) == i, self.weights[i], 0)

    def row_norms_sq(self):
        return jnp.abs(self.weights) ** 2


@pytree_dataclass
class ProdOperator(LinearOperator):
    """Composition ``A ∘ B`` (apply B first), reference ``ProdOp(A, B)``."""

    A: LinearOperator
    B: LinearOperator

    @property
    def in_size(self) -> int:
        return self.B.in_size

    @property
    def out_size(self) -> int:
        return self.A.out_size

    @property
    def dtype(self):
        return self.B.dtype

    def mv(self, x):
        return self.A.mv(self.B.mv(x))

    def rmv(self, y):
        return self.B.rmv(self.A.rmv(y))

    def row(self, i):
        # Efficient only for WeightingOperator ∘ B, the case the reference
        # special-cases for weighted Kaczmarz
        # (/root/reference/src/Kaczmarz.jl:455-458).
        if isinstance(self.A, WeightingOperator):
            return self.A.weights[i] * self.B.row(i)
        raise NotImplementedError("row access only for Weighting ∘ B products")

    def row_norms_sq(self):
        if isinstance(self.A, WeightingOperator):
            return jnp.abs(self.A.weights) ** 2 * self.B.row_norms_sq()
        raise NotImplementedError("row access only for Weighting ∘ B products")


@pytree_dataclass
class NormalOperator(LinearOperator):
    """Wraps A (and optional weights W) as the normal operator AᴴWA.

    Used wherever the reference defaults ``AHA = A'*A``
    (e.g. /root/reference/src/FISTA.jl:58).
    """

    A: LinearOperator
    weights: Optional[Any] = None

    @property
    def in_size(self) -> int:
        return self.A.in_size

    @property
    def out_size(self) -> int:
        return self.A.in_size

    @property
    def dtype(self):
        return self.A.dtype

    def mv(self, x):
        if self.weights is None:
            return self.A.normal(x)
        return self.A.rmv(self.weights * self.A.mv(x))

    def rmv(self, y):
        return self.mv(y)  # hermitian

    def normal(self, x):
        return self.mv(self.mv(x))


@pytree_dataclass
class StackedOperator(LinearOperator):
    """Vertical stack [A1; A2; ...] (multi-coil / constrained systems)."""

    ops: tuple

    @property
    def in_size(self) -> int:
        return self.ops[0].in_size

    @property
    def out_size(self) -> int:
        return sum(op.out_size for op in self.ops)

    @property
    def dtype(self):
        return self.ops[0].dtype

    def mv(self, x):
        return jnp.concatenate([op.mv(x) for op in self.ops])

    def rmv(self, y):
        out = None
        offset = 0
        for op in self.ops:
            part = op.rmv(y[offset : offset + op.out_size])
            out = part if out is None else out + part
            offset += op.out_size
        return out

    def normal(self, x):
        out = None
        for op in self.ops:
            part = op.normal(x)
            out = part if out is None else out + part
        return out


@pytree_dataclass
class SamplingOperator(LinearOperator):
    """Row-sampling operator S: y = x[idx] (reference ``SamplingOp``).
    Adjoint scatters back into zeros."""

    idx: Any  # int32 indices into the input
    n: int = static_field()

    @property
    def in_size(self) -> int:
        return self.n

    @property
    def out_size(self) -> int:
        return self.idx.shape[0]

    @property
    def dtype(self):
        return jnp.complex64

    def mv(self, x):
        return x[self.idx]

    def rmv(self, y):
        return jnp.zeros((self.n,), y.dtype).at[self.idx].set(y)

    def normal(self, x):
        mask = jnp.zeros((self.n,), jnp.float32).at[self.idx].set(1.0)
        return x * mask.astype(x.dtype)


@pytree_dataclass
class _AdjointOperator(LinearOperator):
    inner: LinearOperator

    @property
    def in_size(self) -> int:
        return self.inner.out_size

    @property
    def out_size(self) -> int:
        return self.inner.in_size

    @property
    def dtype(self):
        return self.inner.dtype

    def mv(self, x):
        return self.inner.rmv(x)

    def rmv(self, y):
        return self.inner.mv(y)


def adjoint_operator(op: LinearOperator) -> LinearOperator:
    if isinstance(op, _AdjointOperator):
        return op.inner
    return _AdjointOperator(op)


def as_operator(A) -> LinearOperator:
    """Coerce a raw array / operator into a LinearOperator."""
    if isinstance(A, LinearOperator):
        return A
    A = jnp.asarray(A)
    if A.ndim != 2:
        raise ValueError(f"expected 2-D matrix, got shape {A.shape}")
    return DenseOperator(A)
