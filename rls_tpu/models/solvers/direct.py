"""Direct solvers: regularized normal-equation solve and SVD pseudoinverse.

Behavioral port of /root/reference/src/Direct.jl:
  * DirectSolver — solves (AᴴA + λI)x = Aᴴb (reference uses `lu`,
    Direct.jl:101-133). For real-f32 inputs the solve is dispatched
    through the one-sided Jacobi SVD (x = V·S/(S²+λ)·Uᴴb — identical to
    the regularized normal solve in exact arithmetic), whose rotations
    never touch a matmul unit; `svd_method="lu"` forces the
    factorization path.
  * PseudoInverse — Tikhonov-filtered SVD pinv: x = V · diag(S/(S²+λ)) · Uᴴ b
    with the SVD precomputed at construction (Direct.jl:135-139,152-169),
    same Jacobi dispatch (gate: models/prox._use_jacobi).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax.numpy as jnp

from ..._pytree import pytree_dataclass, replace, static_field
from ...ops.base import LinearOperator, as_operator
from ..prox import L2Regularization, _use_jacobi
from ..regularization import NoNormalization, find_sink, normalization_factor
from .base import LinearSolver, split_projection_terms

__all__ = ["DirectSolver", "PseudoInverse"]


def _split_l2(reg):
    regs = (
        list(reg)
        if isinstance(reg, (list, tuple))
        else ([reg] if reg is not None else [L2Regularization(0.0)])
    )
    idx = find_sink(L2Regularization, regs)
    if idx is None:
        l2 = L2Regularization(0.0)
    else:
        l2 = regs.pop(idx)
    params, proj = split_projection_terms(regs)
    if params:
        raise ValueError(
            "direct solvers do not allow for more than one L2 regularization "
            f"term, found {len(params)} additional terms"
        )
    return l2, proj


def _thin_svd(Ad, method: str = "auto"):
    """Thin SVD with the same accuracy dispatch as the nuclear/LLR proxes:
    one-sided Jacobi (f32-exact elementwise column rotations) where it
    applies, XLA's SVD otherwise. Handles m < n by factoring Aᵀ."""
    if _use_jacobi(Ad, method):
        from ...ops.jacobi_svd import jacobi_svd

        if Ad.shape[-2] < Ad.shape[-1]:
            # A = (Aᵀ)ᵀ = (U' S V'ᵀ)ᵀ → U = V', Vᴴ = U'ᵀ
            u, s, vt = jacobi_svd(jnp.swapaxes(Ad, -1, -2))
            return jnp.swapaxes(vt, -1, -2), s, jnp.swapaxes(u, -1, -2)
        return jacobi_svd(Ad)
    return jnp.linalg.svd(Ad, full_matrices=False)


def _tikhonov_apply(U, S, Vh, lam, b):
    """x = V · S/(S²+λ) · Uᴴ b (Direct.jl:158)."""
    D = S / (S**2 + lam)
    tmp = U.conj().T @ b
    return Vh.conj().T @ (D.astype(tmp.dtype) * tmp)


@pytree_dataclass
class DirectState:
    x: Any
    b: Any
    lam: Any
    iteration: Any


@pytree_dataclass
class DirectSolver(LinearSolver):
    A: LinearOperator
    l2: Any
    proj: Tuple = ()
    normalize_reg: Any = NoNormalization()
    U: Any = None
    S: Any = None
    Vh: Any = None
    iterations: int = static_field(default=1)

    @classmethod
    def create(cls, A, reg=None, normalize_reg=NoNormalization(),
               svd_method: str = "auto", **_):
        l2, proj = _split_l2(reg)
        op = as_operator(A)
        U = S = Vh = None
        if svd_method != "lu":
            Ad = op.to_dense()
            if _use_jacobi(Ad, svd_method):
                U, S, Vh = _thin_svd(Ad, svd_method)
        return cls(A=op, l2=l2, proj=proj, normalize_reg=normalize_reg,
                   U=U, S=S, Vh=Vh)

    def init(self, b, x0=None) -> DirectState:
        b = jnp.asarray(b)
        scale = normalization_factor(self.normalize_reg, self.A, b)
        lam = jnp.real(jnp.asarray(self.l2.get_lam())) * scale
        n = self.A.in_size
        x = (
            jnp.broadcast_to(jnp.asarray(x0, b.dtype), (n,))
            if x0 is not None
            else jnp.zeros((n,), b.dtype)
        )
        return DirectState(x=x, b=b, lam=lam, iteration=jnp.asarray(0, jnp.int32))

    def step(self, state: DirectState) -> DirectState:
        if self.U is not None:
            # Jacobi-SVD route: ≡ (AᴴA+λI)⁻¹Aᴴb in exact arithmetic
            x = _tikhonov_apply(self.U, self.S, self.Vh, state.lam, state.b)
        else:
            Ad = self.A.to_dense()
            n = Ad.shape[1]
            gram = Ad.conj().T @ Ad + state.lam.astype(Ad.dtype) * jnp.eye(
                n, dtype=Ad.dtype
            )
            x = jnp.linalg.solve(gram, Ad.conj().T @ state.b)
        for p in self.proj:
            x = p.prox(x)
        return replace(state, x=x, iteration=state.iteration + 1)

    def done(self, state: DirectState):
        return state.iteration >= 1

    def convergence(self, state: DirectState) -> dict:
        return {}


@pytree_dataclass
class PseudoInverse(LinearSolver):
    U: Any
    S: Any
    Vh: Any
    l2: Any
    proj: Tuple = ()
    normalize_reg: Any = NoNormalization()
    iterations: int = static_field(default=1)

    @classmethod
    def create(cls, A, reg=None, normalize_reg=NoNormalization(),
               svd_method: str = "auto", **_):
        l2, proj = _split_l2(reg)
        Ad = as_operator(A).to_dense()
        U, S, Vh = _thin_svd(Ad, svd_method)
        return cls(U=U, S=S, Vh=Vh, l2=l2, proj=proj, normalize_reg=normalize_reg)

    def init(self, b, x0=None) -> DirectState:
        b = jnp.asarray(b)
        scale = normalization_factor(self.normalize_reg, None, b)
        lam = jnp.real(jnp.asarray(self.l2.get_lam())) * scale
        n = self.Vh.shape[1]
        x = jnp.zeros((n,), b.dtype)
        return DirectState(x=x, b=b, lam=lam, iteration=jnp.asarray(0, jnp.int32))

    def step(self, state: DirectState) -> DirectState:
        x = _tikhonov_apply(self.U, self.S, self.Vh, state.lam, state.b)
        for p in self.proj:
            x = p.prox(x)
        return replace(state, x=x, iteration=state.iteration + 1)

    def done(self, state: DirectState):
        return state.iteration >= 1

    def convergence(self, state: DirectState) -> dict:
        return {}
