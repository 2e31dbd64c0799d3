"""SplitBregman — constrained split Bregman (Goldstein & Osher Eq. 4.7).

Behavioral port of /root/reference/src/SplitBregman.jl: an ADMM-style inner
loop plus an outer Bregman update of the right-hand side
(β_y += y − AᴴA x, SplitBregman.jl:257-267). `iterations=1` reduces to ADMM
(with `iterations_inner` playing ADMM's `iterations`).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import jax.numpy as jnp
from jax import lax

from ..._pytree import pytree_dataclass, replace, static_field
from ...ops.base import IdentityOperator, LinearOperator, as_operator
from ..prox import L1Regularization
from ..regularization import NoNormalization, normalization_factor
from .base import LinearSolver, pcg, prepare_operators, split_projection_terms

__all__ = ["SplitBregman"]


@pytree_dataclass
class SplitBregmanState:
    x: Any
    y: Any
    beta_y: Any
    z: Tuple
    u: Tuple
    rho: Tuple
    rk: Tuple
    sk: Tuple
    eps_pri: Tuple
    eps_dua: Tuple
    sigma_abs: Any
    lam_scale: Any
    iteration: Any  # inner counter (starts at 1, reference :199-201)
    iter_cnt: Any  # outer Bregman counter (starts at 1)


def _as_tuple(x, n):
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return tuple(x for _ in range(n))


@pytree_dataclass
class SplitBregman(LinearSolver):
    A: Optional[LinearOperator]
    AHA: LinearOperator
    reg: Tuple
    reg_trafo: Tuple
    proj: Tuple = ()
    rho0: Tuple = (0.1,)
    precon: Optional[Callable] = static_field(default=None)
    normalize_reg: Any = NoNormalization()
    abs_tol: Any = None
    rel_tol: Any = None
    tol_inner: Any = 1e-5
    iterations: int = static_field(default=10)  # outer Bregman iterations
    iterations_inner: int = static_field(default=10)
    iterations_cg: int = static_field(default=10)
    # python-unrolled masked inner CG (no lax.while_loop inside the step;
    # required by the unrolled drivers, see base.pcg)
    unroll_cg: bool = static_field(default=False)
    verbose: bool = static_field(default=False)

    @classmethod
    def create(
        cls,
        A=None,
        AHA=None,
        reg=None,
        reg_trafo=None,
        precon=None,
        normalize_reg=NoNormalization(),
        rho=1e-1,
        iterations: int = 10,
        iterations_inner: int = 10,
        iterations_cg: int = 10,
        unroll_cg: bool = False,
        abs_tol=None,
        rel_tol=None,
        tol_inner=1e-5,
        verbose: bool = False,
        **_,
    ):
        A_op, AHA_op = prepare_operators(A, AHA)
        if reg is None:
            reg = L1Regularization(0.0)
        params, proj = split_projection_terms(reg)
        n = AHA_op.in_size
        if reg_trafo is None:
            reg_trafo = [IdentityOperator(n, AHA_op.dtype) for _ in params]
        elif not isinstance(reg_trafo, (list, tuple)):
            reg_trafo = [reg_trafo]
        reg_trafo = [as_operator(t) for t in reg_trafo]
        if len(params) != len(reg_trafo):
            raise ValueError("reg and reg_trafo must have the same length")
        rho0 = _as_tuple(rho, len(params))
        return cls(
            A=A_op,
            AHA=AHA_op,
            reg=tuple(params),
            reg_trafo=tuple(reg_trafo),
            proj=proj,
            rho0=tuple(float(r) for r in rho0),
            precon=precon,
            normalize_reg=normalize_reg,
            abs_tol=abs_tol,
            rel_tol=rel_tol,
            tol_inner=tol_inner,
            iterations=iterations,
            iterations_inner=iterations_inner,
            iterations_cg=iterations_cg,
            unroll_cg=unroll_cg,
            verbose=verbose,
        )

    def _composite_mv(self, rho):
        def mv(v):
            out = self.AHA.mv(v)
            for trafo, r in zip(self.reg_trafo, rho):
                out = out + r.astype(v.dtype) * trafo.rmv(trafo.mv(v))
            return out

        return mv

    # -- protocol ----------------------------------------------------------
    def init(self, b, x0=None) -> SplitBregmanState:
        b = jnp.asarray(b)
        beta_y = self.A.rmv(b) if self.A is not None else b
        n = beta_y.shape[0]
        if x0 is not None:
            x = jnp.broadcast_to(jnp.asarray(x0, beta_y.dtype), (n,))
        else:
            x = jnp.zeros((n,), beta_y.dtype)
        rdt = jnp.zeros((), beta_y.dtype).real.dtype
        z = tuple(t.mv(x) for t in self.reg_trafo)
        u = tuple(jnp.zeros_like(zi) for zi in z)
        inf = jnp.asarray(jnp.inf, rdt)
        zero = jnp.asarray(0.0, rdt)
        nreg = len(self.reg)
        abs_tol = (
            jnp.asarray(self.abs_tol, rdt)
            if self.abs_tol is not None
            else jnp.asarray(jnp.finfo(rdt).eps, rdt)
        )
        scale = normalization_factor(self.normalize_reg, self.A, b).astype(rdt)
        return SplitBregmanState(
            x=x,
            y=beta_y,
            beta_y=beta_y,
            z=z,
            u=u,
            rho=tuple(jnp.asarray(r, rdt) for r in self.rho0),
            rk=(inf,) * nreg,
            sk=(inf,) * nreg,
            eps_pri=(zero,) * nreg,
            eps_dua=(zero,) * nreg,
            sigma_abs=jnp.sqrt(jnp.asarray(b.shape[0], rdt)) * abs_tol,
            lam_scale=scale,
            iteration=jnp.asarray(1, jnp.int32),
            iter_cnt=jnp.asarray(1, jnp.int32),
        )

    def step(self, state: SplitBregmanState) -> SplitBregmanState:
        rdt = state.sigma_abs.dtype
        rel_tol_inner = jnp.asarray(self.tol_inner, rdt)

        # x-update (reference SplitBregman.jl:209-218)
        beta = state.beta_y
        for trafo, r, zi, ui in zip(self.reg_trafo, state.rho, state.z, state.u):
            beta = beta + r.astype(beta.dtype) * trafo.rmv(zi - ui)
        x = pcg(
            self._composite_mv(state.rho),
            beta,
            state.x,
            maxiter=self.iterations_cg,
            reltol=rel_tol_inner,
            precon=self.precon,
            unroll=self.unroll_cg,
        )
        for p in self.proj:
            x = p.prox(x)

        # z/u updates + residuals (SplitBregman.jl:225-247); note prox scale
        # is λ/ρ here vs λ/2ρ in ADMM (:235)
        z_new, u_new = [], []
        rk, sk, eps_pri, eps_dua = [], [], [], []
        for i, (reg_i, trafo) in enumerate(zip(self.reg, self.reg_trafo)):
            rho_i = state.rho[i]
            z_old = state.z[i]
            phix = trafo.mv(x)
            zi = phix + state.u[i]
            lam_eff = reg_i.get_lam() * state.lam_scale
            zi_prox = reg_i.prox(zi, lam_eff / jnp.where(rho_i != 0, rho_i, 1.0))
            zi = jnp.where(rho_i != 0, zi_prox, zi)
            ui = state.u[i] + phix - zi

            rk.append(jnp.linalg.norm(phix - zi))
            sk.append(rho_i * jnp.linalg.norm(trafo.rmv(zi - z_old)))
            eps_pri.append(jnp.maximum(jnp.linalg.norm(phix), jnp.linalg.norm(zi)))
            eps_dua.append(rho_i * jnp.linalg.norm(trafo.rmv(ui)))
            z_new.append(zi)
            u_new.append(ui)

        state = replace(
            state,
            x=x,
            z=tuple(z_new),
            u=tuple(u_new),
            rk=tuple(rk),
            sk=tuple(sk),
            eps_pri=tuple(eps_pri),
            eps_dua=tuple(eps_dua),
        )

        # outer Bregman update when inner loop finished (SplitBregman.jl:257-267)
        do_outer = jnp.logical_or(
            self._converged(state), state.iteration >= self.iterations_inner
        )

        def outer(s: SplitBregmanState) -> SplitBregmanState:
            beta_y = s.beta_y + s.y - self.AHA.mv(s.x)
            z = tuple(t.mv(s.x) for t in self.reg_trafo)
            u = tuple(jnp.zeros_like(zi) for zi in s.z)
            return replace(
                s,
                beta_y=beta_y,
                z=z,
                u=u,
                iter_cnt=s.iter_cnt + 1,
                iteration=jnp.asarray(0, jnp.int32),
            )

        state = lax.cond(do_outer, outer, lambda s: s, state)
        return replace(state, iteration=state.iteration + 1)

    def _converged(self, state: SplitBregmanState):
        rdt = state.sigma_abs.dtype
        rel_tol = (
            jnp.asarray(self.rel_tol, rdt)
            if self.rel_tol is not None
            else jnp.asarray(jnp.finfo(rdt).eps, rdt)
        )
        ok = jnp.asarray(True)
        for i in range(len(self.reg)):
            ok = ok & (state.rk[i] < state.sigma_abs + rel_tol * state.eps_pri[i])
            ok = ok & (state.sk[i] < state.sigma_abs + rel_tol * state.eps_dua[i])
        return ok

    @property
    def total_steps(self) -> int:
        # step() advances ONE inner iteration; a full solve is
        # outer Bregman loops x inner ADMM iterations
        return self.iterations * self.iterations_inner

    def done(self, state: SplitBregmanState):
        over = jnp.logical_and(
            state.iteration == 1, state.iter_cnt > self.iterations
        )
        return jnp.logical_or(self._converged(state), over)

    def convergence(self, state: SplitBregmanState) -> dict:
        return {
            "primal": jnp.stack(state.rk),
            "dual": jnp.stack(state.sk),
        }
