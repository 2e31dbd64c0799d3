"""FISTA — accelerated proximal gradient with Nesterov momentum and
optional gradient restart.

Behavioral port of /root/reference/src/FISTA.jl: the whole iteration
(momentum, normal-op matvec, gradient step, prox, restart test, θ update)
is a single pure `step` that XLA fuses into matvec + elementwise + two
reductions — the flagship hot loop of the framework.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax.numpy as jnp

from ..._pytree import pytree_dataclass, replace, static_field
from ...ops.base import LinearOperator
from ...utils.power_iterations import power_iterations
from ..prox import L1Regularization
from ..regularization import NoNormalization, normalization_factor
from .base import LinearSolver, prepare_operators, split_projection_terms

__all__ = ["FISTA"]


@pytree_dataclass
class FISTAState:
    x: Any
    x0hat: Any  # Aᴴb
    x_old: Any
    rho: Any
    theta: Any
    theta_old: Any
    norm_x0: Any
    rel_res_norm: Any
    lam_scale: Any
    rel_tol: Any
    iteration: Any


@pytree_dataclass
class FISTA(LinearSolver):
    A: Optional[LinearOperator]
    AHA: LinearOperator
    reg: Any
    proj: Tuple = ()
    rho: Any = 1.0
    theta: Any = 1.0
    rel_tol: Any = None
    normalize_reg: Any = NoNormalization()
    iterations: int = static_field(default=50)
    restart: str = static_field(default="none")
    verbose: bool = static_field(default=False)
    # skip the per-iteration ‖res‖ reduction (fixed-iteration benchmarking /
    # unrolled mode where early exit is disabled anyway)
    track_residual: bool = static_field(default=True)

    @classmethod
    def create(
        cls,
        A=None,
        AHA=None,
        reg=None,
        normalize_reg=NoNormalization(),
        iterations: int = 50,
        rho=None,
        theta=1.0,
        rel_tol=None,
        restart: str = "none",
        verbose: bool = False,
        track_residual: bool = True,
        **_,
    ):
        """Reference ctor semantics (FISTA.jl:57-92): exactly one
        parameterized term plus any number of projections; default step size
        rho = 0.95 / power_iterations(AHA)."""
        A_op, AHA_op = prepare_operators(A, AHA)
        if reg is None:
            reg = L1Regularization(0.0)
        params, proj = split_projection_terms(reg)
        if len(params) != 1:
            raise ValueError(
                f"FISTA does not allow more additional regularization terms, "
                f"found {len(params)}"
            )
        if rho is None:
            rho = 0.95 / power_iterations(AHA_op)
        return cls(
            A=A_op,
            AHA=AHA_op,
            reg=params[0],
            proj=proj,
            rho=rho,
            theta=theta,
            rel_tol=rel_tol,
            normalize_reg=normalize_reg,
            iterations=iterations,
            restart=restart,
            verbose=verbose,
            track_residual=track_residual,
        )

    # -- protocol --------------------------------------------------------
    def init(self, b, x0=None) -> FISTAState:
        b = jnp.asarray(b)
        x0hat = self.A.rmv(b) if self.A is not None else b
        n = x0hat.shape[0]
        if x0 is not None:
            x = jnp.broadcast_to(jnp.asarray(x0, x0hat.dtype), (n,))
        else:
            x = jnp.zeros((n,), x0hat.dtype)
        norm_x0 = jnp.linalg.norm(x0hat)
        rdt = norm_x0.dtype
        rel_tol = (
            jnp.asarray(self.rel_tol, rdt)
            if self.rel_tol is not None
            else jnp.asarray(jnp.finfo(rdt).eps, rdt)
        )
        scale = normalization_factor(self.normalize_reg, self.A, b).astype(rdt)
        return FISTAState(
            x=x,
            x0hat=x0hat,
            x_old=jnp.zeros_like(x),
            rho=jnp.asarray(self.rho, rdt),
            theta=jnp.asarray(self.theta, rdt),
            theta_old=jnp.asarray(self.theta, rdt),
            norm_x0=norm_x0,
            rel_res_norm=jnp.asarray(jnp.inf, rdt),
            lam_scale=scale,
            rel_tol=rel_tol,
            iteration=jnp.asarray(0, jnp.int32),
        )

    def step(self, state: FISTAState) -> FISTAState:
        # momentum / Nesterov (reference FISTA.jl:144-148)
        alpha = (state.theta_old - 1.0) / state.theta
        x_mom = state.x + alpha.astype(state.x.dtype) * (state.x - state.x_old)
        x_prev = state.x

        # residual + gradient step (FISTA.jl:152-154)
        res = self.AHA.mv(x_mom) - state.x0hat
        x = x_mom - state.rho.astype(res.dtype) * res
        if self.track_residual:
            rel_res = jnp.linalg.norm(res) / state.norm_x0
        else:
            rel_res = state.rel_res_norm

        # proximal map (FISTA.jl:164-168)
        lam_eff = self.reg.get_lam() * state.lam_scale
        x = self.reg.prox(x, state.rho * lam_eff)
        for p in self.proj:
            x = p.prox(x)

        # gradient restart (FISTA.jl:171-176). "gradient" is the
        # reference's raw-∇f test — bug-for-bug faithful, but on strongly
        # nonsmooth problems (LASSO) it fires almost every iteration and
        # degrades FISTA to ISTA-rate (docs/API_PARITY.md §5).
        # "gradient_mapping" is the O'Donoghue–Candès composite test on
        # the PROXIMAL gradient mapping (y − x⁺)·(x⁺ − x) > 0 — identical
        # on smooth problems (res ∝ y − x⁺ there), correct under a prox.
        theta = state.theta
        if self.restart == "gradient":
            obtuse = jnp.real(jnp.vdot(res, x - x_prev)) > 0
            theta = jnp.where(obtuse, jnp.ones_like(theta), theta)
        elif self.restart == "gradient_mapping":
            obtuse = jnp.real(jnp.vdot(x_mom - x, x - x_prev)) > 0
            theta = jnp.where(obtuse, jnp.ones_like(theta), theta)

        theta_old = theta
        theta_new = (1.0 + jnp.sqrt(1.0 + 4.0 * theta_old**2)) / 2.0
        return replace(
            state,
            x=x,
            x_old=x_prev,
            theta=theta_new,
            theta_old=theta_old,
            rel_res_norm=rel_res,
            iteration=state.iteration + 1,
        )

    def done(self, state: FISTAState):
        converged = state.rel_res_norm < state.rel_tol
        return jnp.logical_or(converged, state.iteration >= self.iterations)

    def convergence(self, state: FISTAState) -> dict:
        return {"residual": state.rel_res_norm * state.norm_x0}
