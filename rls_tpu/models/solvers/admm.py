"""ADMM — multi-term consensus ADMM with CG x-update and ρ adaptation.

Behavioral port of /root/reference/src/ADMM.jl. The reference's lazy
"composite AHA with in-place ρ" LinearOperator trick (ADMM.jl:141-159)
becomes a plain closure: the CG matvec recomputes
``AᴴA x + Σᵢ ρᵢ ΦᵢᴴΦᵢ x`` with ρᵢ as traced scalars, so :balance/:PnP
adaptation needs no operator rebuilds or recompilation. The inner CG is the
native `pcg` loop fused inside the same jitted step.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import jax.numpy as jnp

from ..._pytree import pytree_dataclass, replace, static_field
from ...ops.base import IdentityOperator, LinearOperator, as_operator
from ..prox import L1Regularization
from ..regularization import NoNormalization, normalization_factor
from .base import LinearSolver, pcg, prepare_operators, split_projection_terms

__all__ = ["ADMM"]


@pytree_dataclass
class ADMMState:
    x: Any
    x_old: Any
    beta_y: Any  # Aᴴb
    z: Tuple
    u: Tuple
    rho: Tuple
    rk: Tuple
    sk: Tuple
    eps_pri: Tuple
    eps_dua: Tuple
    delta: Tuple
    sigma_abs: Any
    lam_scale: Any
    iteration: Any


def _as_tuple(x, n):
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return tuple(x for _ in range(n))


@pytree_dataclass
class ADMM(LinearSolver):
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
    vary_rho: str = static_field(default="none")
    iterations: int = static_field(default=10)
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
        vary_rho: str = "none",
        iterations: int = 10,
        iterations_cg: int = 10,
        unroll_cg: bool = False,
        abs_tol=None,
        rel_tol=None,
        tol_inner=1e-5,
        verbose: bool = False,
        **_,
    ):
        """Reference ctor semantics (ADMM.jl:80-163): projection terms split
        off; reg/regTrafo must match in length; default Φ = identity."""
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
            vary_rho=vary_rho,
            iterations=iterations,
            iterations_cg=iterations_cg,
            unroll_cg=unroll_cg,
            verbose=verbose,
        )

    # -- helpers ----------------------------------------------------------
    def _composite_mv(self, rho):
        def mv(v):
            out = self.AHA.mv(v)
            for trafo, r in zip(self.reg_trafo, rho):
                out = out + r.astype(v.dtype) * trafo.rmv(trafo.mv(v))
            return out

        return mv

    def _rdt(self, b):
        return jnp.zeros((), b.dtype).real.dtype

    # -- protocol ----------------------------------------------------------
    def init(self, b, x0=None) -> ADMMState:
        b = jnp.asarray(b)
        beta_y = self.A.rmv(b) if self.A is not None else b
        n = beta_y.shape[0]
        if x0 is not None:
            x = jnp.broadcast_to(jnp.asarray(x0, beta_y.dtype), (n,))
        else:
            x = jnp.zeros((n,), beta_y.dtype)
        rdt = self._rdt(beta_y)
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
        return ADMMState(
            x=x,
            x_old=x,
            beta_y=beta_y,
            z=z,
            u=u,
            rho=tuple(jnp.asarray(r, rdt) for r in self.rho0),
            rk=(inf,) * nreg,
            sk=(inf,) * nreg,
            eps_pri=(zero,) * nreg,
            eps_dua=(zero,) * nreg,
            delta=(inf,) * nreg,
            sigma_abs=jnp.sqrt(jnp.asarray(b.shape[0], rdt)) * abs_tol,
            lam_scale=scale,
            iteration=jnp.asarray(0, jnp.int32),
        )

    def step(self, state: ADMMState) -> ADMMState:
        rdt = state.sigma_abs.dtype
        rel_tol_inner = jnp.asarray(self.tol_inner, rdt)

        # 1. x-update: argmin ½‖Ax−b‖² + Σ ρᵢ/2‖Φᵢx + uᵢ − zᵢ‖² via CG
        # (reference ADMM.jl:234-244)
        beta = state.beta_y
        for trafo, r, zi, ui in zip(self.reg_trafo, state.rho, state.z, state.u):
            beta = beta + r.astype(beta.dtype) * trafo.rmv(zi - ui)
        x_old = state.x
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

        # 2./3. per-term z/u updates + residuals + ρ adaptation
        # (reference ADMM.jl:251-309)
        z_new, u_new, rho_new = [], [], []
        rk, sk, eps_pri, eps_dua, delta = [], [], [], [], []
        dx_norm = jnp.linalg.norm(x - x_old)
        for i, (reg_i, trafo) in enumerate(zip(self.reg, self.reg_trafo)):
            rho_i = state.rho[i]
            z_old = state.z[i]
            u_old = state.u[i]

            phix = trafo.mv(x)
            zi = phix + u_old
            lam_eff = reg_i.get_lam() * state.lam_scale
            zi_prox = reg_i.prox(zi, lam_eff / (2.0 * jnp.where(rho_i != 0, rho_i, 1.0)))
            zi = jnp.where(rho_i != 0, zi_prox, zi)

            ui = u_old + phix - zi

            delta_i = (
                dx_norm
                + jnp.linalg.norm(zi - z_old)
                + jnp.linalg.norm(ui - u_old)
            )
            sk_i = rho_i * jnp.linalg.norm(trafo.rmv(zi - z_old))
            eps_pri_i = jnp.maximum(jnp.linalg.norm(phix), jnp.linalg.norm(zi))
            rk_i = jnp.linalg.norm(phix - zi)
            eps_dua_i = rho_i * jnp.linalg.norm(trafo.rmv(ui))

            # ρ adaptation (Boyd :balance / Chang :PnP, ADMM.jl:302-309)
            if self.vary_rho == "balance":
                up = rk_i / eps_pri_i > 10.0 * sk_i / eps_dua_i
                down = sk_i / eps_dua_i > 10.0 * rk_i / eps_pri_i
                rho_i2 = jnp.where(up, rho_i * 2, jnp.where(down, rho_i / 2, rho_i))
                ui = jnp.where(up, ui / 2, jnp.where(down, ui * 2, ui))
                rho_i = rho_i2
            elif self.vary_rho == "PnP":
                up = delta_i / state.delta[i] > 0.9
                rho_i = jnp.where(up, rho_i * 2, rho_i)
                ui = jnp.where(up, ui / 2, ui)

            z_new.append(zi)
            u_new.append(ui)
            rho_new.append(rho_i)
            rk.append(rk_i)
            sk.append(sk_i)
            eps_pri.append(eps_pri_i)
            eps_dua.append(eps_dua_i)
            delta.append(delta_i)

        return replace(
            state,
            x=x,
            x_old=x_old,
            z=tuple(z_new),
            u=tuple(u_new),
            rho=tuple(rho_new),
            rk=tuple(rk),
            sk=tuple(sk),
            eps_pri=tuple(eps_pri),
            eps_dua=tuple(eps_dua),
            delta=tuple(delta),
            iteration=state.iteration + 1,
        )

    def _converged(self, state: ADMMState):
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

    def done(self, state: ADMMState):
        return jnp.logical_or(
            self._converged(state), state.iteration >= self.iterations
        )

    def convergence(self, state: ADMMState) -> dict:
        return {
            "primal": jnp.stack(state.rk),
            "dual": jnp.stack(state.sk),
        }
