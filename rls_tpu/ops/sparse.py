"""Sparse operators.

Reference analog: SparseMatrixCSC system matrices with specialized
``rownorm²`` / ``dot_with_matrix_row`` / ``kaczmarz_update!``
(/root/reference/src/Utils.jl:26-31,96-105, /root/reference/src/Kaczmarz.jl:532-539).

Two representations:

* ``SparseOperator`` — jax.experimental.sparse BCOO; matvecs via BCOO
  matmul, but scalar row access is an O(nnz) masked gather over the whole
  matrix — row-action sweeps cost O(m·nnz).
* ``PaddedCSROperator`` — row-major padded storage ``vals/cols`` of shape
  (m, k_max): every row padded to the max row population. `row_dot` /
  `row_axpy` are O(k_max) gathers/scatters — the equivalent of the
  reference's CSC fast paths: a Kaczmarz sweep costs O(m·k_max) instead
  of O(m·nnz). Static shapes throughout (XLA-friendly); the padding
  ratio is the only overhead, so it fits row-sparse matrices with
  roughly balanced row populations (the reference's CSC kernels have the
  same "sparse rows" sweet spot).
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp
from jax.experimental import sparse as jsparse

from .._pytree import pytree_dataclass, static_field
from .base import LinearOperator

__all__ = ["SparseOperator", "PaddedCSROperator"]


@pytree_dataclass
class SparseOperator(LinearOperator):
    mat: Any  # BCOO

    @classmethod
    def from_dense(cls, dense):
        return cls(jsparse.BCOO.fromdense(jnp.asarray(dense)))

    @property
    def in_size(self) -> int:
        return self.mat.shape[1]

    @property
    def out_size(self) -> int:
        return self.mat.shape[0]

    @property
    def dtype(self):
        return self.mat.dtype

    def mv(self, x):
        return self.mat @ x

    def rmv(self, y):
        # BCOO transpose matvec: (Aᴴ y) = conj(Aᵀ conj(y))
        return jnp.conj(self.mat.T @ jnp.conj(y))

    def row(self, i):
        # densified row gather: sum of nonzeros whose row index == i
        data, indices = self.mat.data, self.mat.indices
        rowmask = (indices[:, 0] == i).astype(self.mat.dtype)
        out = jnp.zeros((self.in_size,), dtype=self.mat.dtype)
        return out.at[indices[:, 1]].add(data * rowmask)

    def row_norms_sq(self):
        data, indices = self.mat.data, self.mat.indices
        out = jnp.zeros((self.out_size,), dtype=jnp.float32)
        return out.at[indices[:, 0]].add(jnp.abs(data) ** 2)

    def to_dense(self):
        return self.mat.todense()


@pytree_dataclass
class PaddedCSROperator(LinearOperator):
    """Row-major padded sparse storage with O(k_max) row actions.

    ``vals``/``cols`` are (m, k_max); rows with fewer nonzeros are padded
    with val 0 at col 0 (a zero scatter/gather contribution). All row
    actions are static-shape gathers over one row — no dynamic shapes,
    no per-row host logic.
    """

    vals: Any  # (m, k_max)
    cols: Any  # (m, k_max) int32
    n: int = static_field()

    @classmethod
    def from_dense(cls, dense, k_max: int | None = None):
        """Build from a dense (numpy/jnp) matrix host-side."""
        import numpy as np

        d = np.asarray(dense)
        m, n = d.shape
        counts = (d != 0).sum(axis=1)
        k = int(counts.max()) if k_max is None else int(k_max)
        if (counts > k).any():
            raise ValueError(f"k_max={k} below max row population {counts.max()}")
        k = max(k, 1)
        vals = np.zeros((m, k), d.dtype)
        cols = np.zeros((m, k), np.int32)
        for i in range(m):
            nz = np.nonzero(d[i])[0][:k]
            vals[i, : nz.size] = d[i, nz]
            cols[i, : nz.size] = nz
        return cls(vals=jnp.asarray(vals), cols=jnp.asarray(cols), n=n)

    @property
    def in_size(self) -> int:
        return self.n

    @property
    def out_size(self) -> int:
        return self.vals.shape[0]

    @property
    def dtype(self):
        return self.vals.dtype

    def mv(self, x):
        return jnp.sum(self.vals * x[self.cols], axis=1)

    def rmv(self, y):
        out = jnp.zeros((self.n,), jnp.result_type(self.dtype, y.dtype))
        contrib = jnp.conj(self.vals) * y[:, None]
        return out.at[self.cols.reshape(-1)].add(contrib.reshape(-1))

    def row(self, i):
        out = jnp.zeros((self.n,), self.dtype)
        return out.at[self.cols[i]].add(self.vals[i])

    def row_dot(self, i, x):
        # O(k_max) gather — the reference's CSC dot_with_matrix_row
        return jnp.sum(self.vals[i] * x[self.cols[i]])

    def row_axpy(self, x, i, alpha):
        # O(k_max) scatter-add — the reference's CSC kaczmarz_update!
        return x.at[self.cols[i]].add(alpha * jnp.conj(self.vals[i]))

    def row_norms_sq(self):
        return jnp.sum(jnp.abs(self.vals) ** 2, axis=1).real

    def to_dense(self):
        m = self.vals.shape[0]
        out = jnp.zeros((m, self.n), self.dtype)
        rows = jnp.broadcast_to(
            jnp.arange(m, dtype=jnp.int32)[:, None], self.cols.shape
        )
        return out.at[rows.reshape(-1), self.cols.reshape(-1)].add(
            self.vals.reshape(-1)
        )
