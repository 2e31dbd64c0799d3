"""Dax row-relaxation solvers.

Behavioral ports of /root/reference/src/DAXKaczmarz.jl and
DAXConstrained.jl (both disabled in the reference's include list,
RegularizedLeastSquares.jl:195-196, but part of its API surface):

  * DaxKaczmarz — Dax (1993) row relaxation: outer loop recomputes the
    residual b_k = u − A x, inner loop runs weighted-probability randomized
    Kaczmarz on min ε‖x‖² + ‖W(Ax − b_k)‖², then x += x_l.
  * DaxConstrained — the same with a Lent–Censor scheme enforcing B x ≥ 0
    per inner sweep (B defaults to the identity).

The mapping mirrors Kaczmarz: `lax.scan` over row updates with gathered
rows; the weighted sampling (CDF inversion, DAXKaczmarz.jl:157-165) becomes
`jax.random.choice` with row-energy probabilities.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..._pytree import pytree_dataclass, replace, static_field
from ...ops.base import IdentityOperator, LinearOperator, as_operator
from ..prox import PositiveRegularization, RealRegularization
from ..regularization import TransformedRegularization
from .base import LinearSolver, kaczmarz_row_update

__all__ = ["DaxKaczmarz", "DaxConstrained"]


@pytree_dataclass
class DaxState:
    u: Any
    x: Any
    bk: Any
    key: Any
    iteration: Any


def _build_reg(enforce_real, enforce_positive, sparse_trafo):
    reg = []
    if enforce_positive and enforce_real:
        reg.append(PositiveRegularization())
    elif enforce_real:
        reg.append(RealRegularization())
    if reg and sparse_trafo is not None:
        reg = [TransformedRegularization(r, sparse_trafo) for r in reg]
    return tuple(reg)


@pytree_dataclass
class DaxKaczmarz(LinearSolver):
    A: LinearOperator
    reg: Tuple = ()
    lam: Any = 0.0
    weights: Any = None
    denom: Any = None  # w²/(s² + λ) per row (0 for zero rows)
    probs: Any = None  # sampling probabilities ∝ (s² + λ) over nonzero rows
    eps_w: Any = None  # √λ / w per row
    iterations: int = static_field(default=3)
    iterations_inner: int = static_field(default=2)
    seed: int = static_field(default=42)
    # reference rowindex length: rows with nonzero energy (DAXKaczmarz.jl:115)
    n_nonzero_rows: int = static_field(default=0)

    @classmethod
    def create(
        cls,
        A,
        lam: float = 0.0,
        weights=None,
        sparse_trafo=None,
        enforce_real: bool = False,
        enforce_positive: bool = False,
        iterations: int = 3,
        iterations_inner: int = 2,
        seed: int = 42,
        **_,
    ):
        A_op = as_operator(A)
        m = A_op.out_size
        w = (
            jnp.asarray(weights, jnp.float32)
            if weights is not None
            else jnp.ones((m,), jnp.float32)
        )
        s2 = A_op.row_norms_sq() * w**2
        nz = s2 > 0
        denom = jnp.where(nz, w**2 / (s2 + lam), 0.0)
        probs = jnp.where(nz, s2 + lam, 0.0)
        probs = probs / jnp.sum(probs)
        eps_w = jnp.where(w > 0, jnp.sqrt(jnp.asarray(lam, jnp.float32)) / w, 0.0)
        return cls(
            A=A_op,
            reg=_build_reg(enforce_real, enforce_positive, sparse_trafo),
            lam=jnp.asarray(lam, jnp.float32),
            weights=w,
            denom=denom,
            probs=probs,
            eps_w=eps_w,
            n_nonzero_rows=int(jnp.sum(nz)),
            iterations=iterations,
            iterations_inner=iterations_inner,
            seed=seed,
        )

    def init(self, b, x0=None) -> DaxState:
        b = jnp.asarray(b)
        n = self.A.in_size
        x = (
            jnp.broadcast_to(jnp.asarray(x0, b.dtype), (n,))
            if x0 is not None
            else jnp.zeros((n,), b.dtype)
        )
        return DaxState(
            u=b,
            x=x,
            bk=jnp.zeros_like(b),
            key=jax.random.PRNGKey(self.seed),
            iteration=jnp.asarray(0, jnp.int32),
        )

    def step(self, state: DaxState) -> DaxState:
        m = self.A.out_size
        bk = state.u - self.A.mv(state.x)
        # the reference runs length(rowindex)·iterationsInner inner updates
        # where rowindex holds only rows with nonzero energy
        # (DAXKaczmarz.jl:115); n_nonzero_rows is counted at create
        n_inner = self.n_nonzero_rows * self.iterations_inner

        key, sub = jax.random.split(state.key)
        rows = jax.random.choice(sub, m, shape=(n_inner,), p=self.probs)

        def body(carry, j):
            xl, yl = carry
            xl, yl = kaczmarz_row_update(
                self.A, xl, yl, j, bk[j], self.denom[j], self.eps_w[j]
            )
            return (xl, yl), None

        xl0 = jnp.zeros((self.A.in_size,), state.x.dtype)
        yl0 = jnp.zeros((m,), state.x.dtype)
        (xl, _), _ = lax.scan(body, (xl0, yl0), rows)
        return replace(
            state, x=state.x + xl, bk=bk, key=key, iteration=state.iteration + 1
        )

    def done(self, state: DaxState):
        return state.iteration >= self.iterations

    def finalize(self, state: DaxState) -> DaxState:
        x = state.x
        for r in self.reg:
            x = r.prox(x)
        return replace(state, x=x)

    def convergence(self, state: DaxState) -> dict:
        return {"residual": jnp.linalg.norm(state.bk)}


@pytree_dataclass
class DaxConstrained(LinearSolver):
    """Dax method for Ax ≈ b s.t. Bx ≥ 0 (Lent–Censor scheme)."""

    A: LinearOperator
    B: LinearOperator  # constraint basis (identity by default)
    Bnorm2: Any = None
    lam: Any = 0.0
    weights: Any = None
    denom: Any = None
    eps_w: Any = None
    iterations: int = static_field(default=3)
    iterations_inner: int = static_field(default=2)

    @classmethod
    def create(
        cls,
        A,
        lam: float = 0.0,
        weights=None,
        sparse_trafo=None,
        iterations: int = 3,
        iterations_inner: int = 2,
        **_,
    ):
        A_op = as_operator(A)
        m = A_op.out_size
        n = A_op.in_size
        w = (
            jnp.asarray(weights, jnp.float32)
            if weights is not None
            else jnp.ones((m,), jnp.float32)
        )
        s2 = A_op.row_norms_sq() * w**2
        nz = s2 > 0
        denom = jnp.where(nz, w**2 / (s2 + lam), 0.0)
        eps_w = jnp.where(w > 0, jnp.sqrt(jnp.asarray(lam, jnp.float32)) / w, 0.0)
        B_op = (
            as_operator(sparse_trafo)
            if sparse_trafo is not None
            else IdentityOperator(n, jnp.float32)
        )
        Bn2 = B_op.row_norms_sq()
        return cls(
            A=A_op,
            B=B_op,
            Bnorm2=Bn2,
            lam=jnp.asarray(lam, jnp.float32),
            weights=w,
            denom=denom,
            eps_w=eps_w,
            iterations=iterations,
            iterations_inner=iterations_inner,
        )

    def init(self, b, x0=None) -> DaxState:
        b = jnp.asarray(b)
        n = self.A.in_size
        x = (
            jnp.broadcast_to(jnp.asarray(x0, b.dtype), (n,))
            if x0 is not None
            else jnp.zeros((n,), b.dtype)
        )
        return DaxState(
            u=b,
            x=x,
            bk=jnp.zeros_like(b),
            key=jax.random.PRNGKey(0),
            iteration=jnp.asarray(0, jnp.int32),
        )

    def step(self, state: DaxState) -> DaxState:
        m = self.A.out_size
        nB = self.B.out_size
        bk = state.u - self.A.mv(state.x)

        def row_sweep(carry, j):
            xl, yl = carry
            xl, yl = kaczmarz_row_update(
                self.A, xl, yl, j, bk[j], self.denom[j], self.eps_w[j]
            )
            return (xl, yl), None

        def censor_sweep(carry, i):
            # Lent–Censor: enforce (B(x + xl))_i ≥ 0 using dual memory yc
            xl, bc, yc = carry
            brow = self.B.row(i)
            d = jnp.sum(brow * bc) / self.Bnorm2[i].astype(bc.dtype)
            d = jnp.where(jnp.real(d) < jnp.real(yc[i]), -d, -yc[i])
            yc = yc.at[i].add(d)
            xl = xl + d * jnp.conj(brow)
            bc = bc + d * jnp.conj(brow)
            return (xl, bc, yc), None

        xl = jnp.zeros((self.A.in_size,), state.x.dtype)
        yl = jnp.zeros((m,), state.x.dtype)
        yc = jnp.zeros((nB,), state.x.dtype)
        for _ in range(self.iterations_inner):
            (xl, yl), _ = lax.scan(row_sweep, (xl, yl), jnp.arange(m))
            bc = state.x + xl
            (xl, bc, yc), _ = lax.scan(censor_sweep, (xl, bc, yc), jnp.arange(nB))

        return replace(state, x=state.x + xl, bk=bk, iteration=state.iteration + 1)

    def done(self, state: DaxState):
        return state.iteration >= self.iterations

    def convergence(self, state: DaxState) -> dict:
        return {"residual": jnp.linalg.norm(state.bk)}
