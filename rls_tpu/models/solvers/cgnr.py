"""CGNR — conjugate gradient on the normal equations (AᴴA + λI)x = Aᴴb.

Behavioral port of /root/reference/src/CGNR.jl (structure re-designed as a
pure JAX step; every iteration is one normal-op matvec + three reductions,
which XLA fuses and psum-shards under a mesh).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax.numpy as jnp

from ..._pytree import pytree_dataclass, replace, static_field
from ...ops.base import LinearOperator
from ..prox import L2Regularization, PositiveRegularization, RealRegularization
from ..regularization import (
    NoNormalization,
    find_sink,
    find_sinks,
    normalization_factor,
    sink,
)
from .base import LinearSolver, split_projection_terms, prepare_operators

__all__ = ["CGNR", "solve_cgnr_refined"]


@pytree_dataclass
class CGNRState:
    x: Any
    r: Any  # current Aᴴ-residual (reference's x₀ vector)
    p: Any
    z0: Any
    lam: Any  # effective λ (base λ × normalization factor)
    rel_tol: Any
    iteration: Any


@pytree_dataclass
class CGNR(LinearSolver):
    A: Optional[LinearOperator]
    AHA: LinearOperator
    l2: L2Regularization
    constr: Tuple = ()
    normalize_reg: Any = NoNormalization()
    rel_tol: Any = None
    iterations: int = static_field(default=10)

    @classmethod
    def create(
        cls,
        A=None,
        AHA=None,
        reg=None,
        normalize_reg=NoNormalization(),
        iterations: int = 10,
        rel_tol=None,
        **_,
    ):
        """Reference ctor semantics (CGNR.jl:48-89): only an L2 term plus
        optional Real/Positive projections are allowed."""
        A_op, AHA_op = prepare_operators(A, AHA)
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
        keep = find_sinks(RealRegularization, regs) + find_sinks(
            PositiveRegularization, regs
        )
        constr = tuple(regs[i] for i in sorted(set(keep)))
        rest = [r for i, r in enumerate(regs) if i not in set(keep)]
        if rest:
            raise ValueError(
                f"CGNR does not allow additional regularization terms, found {len(rest)}"
            )
        return cls(
            A=A_op,
            AHA=AHA_op,
            l2=l2,
            constr=constr,
            normalize_reg=normalize_reg,
            rel_tol=rel_tol,
            iterations=iterations,
        )

    # -- protocol --------------------------------------------------------
    def init(self, b, x0=None) -> CGNRState:
        b = jnp.asarray(b)
        n = self.AHA.in_size
        if x0 is not None:
            if self.A is None:
                raise ValueError("providing x0 requires A to be defined")
            x = jnp.broadcast_to(jnp.asarray(x0, b.dtype), (n,))
            b = b - self.A.mv(x)
        else:
            x = jnp.zeros((n,), b.dtype)
        r = self.A.rmv(b) if self.A is not None else b
        z0 = jnp.linalg.norm(r)
        scale = normalization_factor(self.normalize_reg, self.A, b)
        lam = jnp.real(jnp.asarray(self.l2.get_lam())) * scale
        rdt = z0.dtype
        rel_tol = (
            jnp.asarray(self.rel_tol, rdt)
            if self.rel_tol is not None
            else jnp.asarray(jnp.finfo(rdt).eps, rdt)
        )
        return CGNRState(
            x=x,
            r=r,
            p=r,
            z0=z0,
            lam=lam.astype(rdt),
            rel_tol=rel_tol,
            iteration=jnp.asarray(0, jnp.int32),
        )

    def step(self, state: CGNRState) -> CGNRState:
        v = self.AHA.mv(state.p)
        zeta = jnp.linalg.norm(state.r) ** 2
        pv = jnp.vdot(state.p, v)
        lam = state.lam
        denom = pv + lam * jnp.linalg.norm(state.p) ** 2
        # guarded divisions: at exact convergence r = p = 0 ⇒ ζ = denom = 0,
        # and the raw 0/0 would poison the unrolled (no-early-exit) paths —
        # with the guards the step is the identity there, so running past
        # convergence is harmless (same guards as the in-kernel masked CGs)
        alpha = jnp.where(zeta > 0, zeta / jnp.where(denom == 0, 1, denom), 0)
        x = state.x + alpha * state.p
        r = state.r - alpha * v - (lam * alpha) * state.p
        beta = jnp.linalg.norm(r) ** 2 / jnp.where(zeta > 0, zeta, 1)
        p = r + beta * state.p
        return replace(state, x=x, r=r, p=p, iteration=state.iteration + 1)

    @property
    def total_steps(self) -> int:
        # CG terminates in ≤ n steps (reference CGNR.jl caps the same
        # way); the unrolled fixed-step paths must mirror this so they
        # match the early-exit scan path exactly
        return min(self.iterations, self.AHA.in_size)

    def done(self, state: CGNRState):
        converged = jnp.linalg.norm(state.r) / state.z0 <= state.rel_tol
        return jnp.logical_or(converged, state.iteration >= self.total_steps)

    def finalize(self, state: CGNRState) -> CGNRState:
        # projections applied once at convergence (reference CGNR.jl:144-148)
        x = state.x
        for r in self.constr:
            x = r.prox(x)
        return replace(state, x=x)

    def solution(self, state: CGNRState):
        return state.x

    def convergence(self, state: CGNRState) -> dict:
        return {"residual": jnp.linalg.norm(state.r)}


def _cg_normal_reorth(AHA, lam, rhs, iterations: int):
    """CG on (AᴴA + λ)d = rhs with FULL residual reorthogonalization.

    Plain f32 CG on cond(AᴴA) ≈ 4e4 loses Krylov orthogonality and
    STALLS (~3e-2 relative error, independent of the right-hand side — so
    naive restarted refinement cannot contract either). Storing the
    normalized residuals and re-orthogonalizing each new residual against
    all of them (twice — "twice is enough") restores finite termination:
    ≤ n steps to the f32 attainable floor ~κ·ε. The basis is (K, n) with
    K = min(iterations, n) — two small matmuls per iteration, COMPENSATED
    for real f32: where the matmul unit rounds its inputs below f32, a
    raw projection loses exactly the orthogonality this basis exists to
    restore.
    """
    import jax.lax as lax

    n = rhs.shape[0]
    K = min(iterations, n)
    dt = rhs.dtype
    if dt == jnp.float32:
        from ...ops._precise import mm_both

        def project(Q, r):
            coeffs = mm_both(Q.conj(), r[:, None])
            return mm_both(Q.T, coeffs)[:, 0]
    else:

        def project(Q, r):
            return Q.T @ (Q.conj() @ r)

    def vdot(a, b):
        # explicit elementwise+reduce: a vector dot may otherwise lower
        # onto a matmul unit that rounds its inputs
        return jnp.sum(jnp.conj(a) * b).real

    z00 = vdot(rhs, rhs)
    tiny = jnp.asarray(jnp.finfo(jnp.float32).tiny, z00.dtype)
    qnorm = jnp.sqrt(jnp.maximum(z00, tiny))
    Q0 = jnp.zeros((K, n), dt).at[0].set(rhs / qnorm.astype(dt))

    def body(k, carry):
        x, r, p, zeta, Q = carry
        live = (zeta > 1e-14 * z00).astype(z00.dtype)
        v = AHA.mv(p) + lam.astype(dt) * p
        denom = vdot(p, v)
        alpha = (zeta / jnp.where(denom > 0, denom, 1.0)) * live
        x = x + alpha.astype(dt) * p
        r = r - alpha.astype(dt) * v
        for _ in range(2):  # full reorthogonalization, twice
            r = r - project(Q, r)
        znew = vdot(r, r)
        beta = znew / jnp.where(zeta > 0, zeta, 1.0)
        p = r + beta.astype(dt) * p
        qrow = r / jnp.sqrt(jnp.maximum(znew, tiny)).astype(dt)
        Q = lax.dynamic_update_slice(
            Q, (qrow * live.astype(dt))[None], (jnp.minimum(k + 1, K - 1), 0)
        )
        return (x, r, p, znew, Q)

    x0 = jnp.zeros_like(rhs)
    x, *_ = lax.fori_loop(0, K, body, (x0, rhs, rhs, z00, Q0))
    return x


def solve_cgnr_refined(solver: CGNR, b, rounds: int = 3):
    """CGNR with reorthogonalized inner CG + iterative refinement — f32
    accuracy for ill-conditioned normal equations.

    A single f32 CG run on cond(AᴴA) ≈ 4e4 stalls ~3e-2 from the
    regularized solution, while the f64 reference converges (finite
    termination in ≤ n steps; /root/reference/test/testSolvers.jl:240-261
    runs Float64). Two ingredients restore f32 convergence:

    1. the inner CG fully reorthogonalizes its residuals
       (`_cg_normal_reorth`), reaching the f32 attainable floor ~κ·ε per
       run instead of stalling;
    2. refinement rounds recompute the TRUE normal-equation residual

           s = Aᴴ(b − A x) − λ_eff·x

       with the operator's compensated matvecs (the −λx term matters: a
       plain warm restart via ``init(b, x0)`` drops it and drifts toward
       the UNregularized solution at the λ/σ_min level) and solve
       (AᴴA + λ)d = s for the correction. Each round contracts the error
       by the inner solve's relative accuracy (~κ·ε ≈ 2e-3 at κ = 4e4),
       so ``rounds=3`` lands at the ~1e-5 residual-evaluation floor.

    The iterate is accumulated in double-single (hi/lo f32 pair, TwoSum)
    so the cross-round additions never round at f32 eps. Pure
    fori_loop/matmul.
    """
    if solver.A is None:
        raise ValueError("solve_cgnr_refined requires solver.A")
    b = jnp.asarray(b)

    state = solver.init(b)  # for lam_eff (normalization) + rhs Aᴴb
    lam = state.lam
    xh = _cg_normal_reorth(solver.AHA, lam, state.r, solver.iterations)
    xl = jnp.zeros_like(xh)
    for _ in range(max(0, rounds - 1)):
        x = xh + xl
        s = solver.A.rmv(b - solver.A.mv(x)) - lam.astype(x.dtype) * x
        d = _cg_normal_reorth(solver.AHA, lam, s, solver.iterations)
        # TwoSum accumulate: xh + d exactly, rounding captured in xl
        t = xh + d
        bb = t - xh
        err = (xh - (t - bb)) + (d - bb)
        xh, xl = t, xl + err
    x = xh + xl
    for rg in solver.constr:
        x = rg.prox(x)
    return x
