"""Kaczmarz / ART — regularized row-action solver.

Behavioral port of /root/reference/src/Kaczmarz.jl with all four row
selection modes: cyclic, shuffled, randomized (row-energy sampling without
replacement, Kaczmarz.jl:267-269) and greedy randomized (residual-driven
e_k-thresholded sampling, :393-426). The implicit dual vector ``vl`` realizes
the L2 term with ``εw = √λ`` (:303-317); vector-λ Tikhonov is handled by the
standard-form transform ``Â = A·diag(1/√λ)`` with solution rescale
(:378-391, :257-259).

The inherently sequential row recurrence runs as a `lax.scan` over the
sweep's row indices with dynamically gathered rows — exact reference
semantics.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..._pytree import pytree_dataclass, replace, static_field
from ...ops.base import DenseOperator, LinearOperator, as_operator
from ..prox import L2Regularization
from ..regularization import (
    MeasurementBasedNormalization,
    NoNormalization,
    SystemMatrixBasedNormalization,
    find_sink,
    normalization_factor,
    sink,
)
from .base import LinearSolver, kaczmarz_row_update, split_projection_terms

__all__ = ["Kaczmarz"]


@pytree_dataclass
class KaczmarzState:
    u: Any
    x: Any
    vl: Any
    eps_w: Any
    denom: Any
    key: Any
    lam_scale: Any
    iteration: Any
    # greedy extras (zeros when unused)
    r: Any


@pytree_dataclass
class Kaczmarz(LinearSolver):
    A: LinearOperator
    l2: Any
    reg: Tuple = ()
    probabilities: Any = None  # row-energy sampling weights (randomized)
    greedy_B: Any = None  # (AAᴴ + λI)·diag(denom) for greedy residual updates
    greedy_norms: Any = None  # rownorm² + λ
    greedy_fnorm: Any = None  # 1 / (‖A‖_F² + λ)
    tikhonov_inv_sqrt: Any = None  # 1/√λ vector for solution rescale
    theta: Any = None
    perm: Any = None  # row visit order (arange, or shuffled at create)
    # (iterations, K) host-precomputed row order for the randomized mode —
    # replaces the in-loop jax.random.choice with a table lookup;
    # energy-weighted sampling without replacement, like the reference's
    # per-sweep sample! (Kaczmarz.jl:267-269)
    precomputed_order: Any = None
    normalize_reg: Any = NoNormalization()
    randomized: bool = static_field(default=False)
    sub_matrix_size: int = static_field(default=1)
    shuffle_rows: bool = static_field(default=False)
    greedy: bool = static_field(default=False)
    seed: int = static_field(default=1234)
    iterations: int = static_field(default=10)

    @classmethod
    def create(
        cls,
        A,
        reg=None,
        normalize_reg=NoNormalization(),
        randomized: bool = False,
        sub_matrix_fraction: float = 0.15,
        shuffle_rows: bool = False,
        seed: int = 1234,
        iterations: int = 10,
        greedy_randomized: bool = False,
        theta: Optional[float] = None,
        precompute_order: bool = False,
        **_,
    ):
        """Reference ctor semantics (Kaczmarz.jl:77-158).

        ``precompute_order=True`` (randomized mode) samples every sweep's
        row set host-side at construction instead of in-loop with
        jax.random; statistically equivalent to the reference's per-sweep
        `sample!`."""
        A_op = as_operator(A)
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

        lam = sink(l2).lam
        lam_is_vec = hasattr(lam, "ndim") and jnp.ndim(lam) > 0
        if lam_is_vec and not isinstance(
            normalize_reg, (NoNormalization, SystemMatrixBasedNormalization)
        ):
            raise ValueError(
                "Tikhonov matrix for Kaczmarz is only valid with no or system "
                "matrix based normalization"
            )

        if isinstance(normalize_reg, SystemMatrixBasedNormalization):
            # the factor depends only on A, so fold it into λ HERE — before
            # the vector-λ standard-form transform and the greedy tables
            # below consume λ (the reference scales λ in the constructor,
            # Kaczmarz.jl:85 + NormalizedRegularization.jl:47-58; deferring
            # to init would leave those consumers with the raw λ)
            scale0 = normalization_factor(normalize_reg, A_op, None)
            lam = jnp.asarray(lam) * scale0
            l2 = L2Regularization(lam)
            normalize_reg = NoNormalization()

        params, proj = split_projection_terms(regs)
        other = list(proj)
        if len(params) == 1:
            other.append(params[0])
        elif len(params) > 1:
            raise ValueError(
                "Kaczmarz does not allow for more than one additional "
                f"regularization term, found {len(params)}"
            )

        tikhonov_inv_sqrt = None
        if lam_is_vec:
            # standard-form transform Â = A·diag(1/√λ) (Kaczmarz.jl:378-391)
            inv_sqrt = 1.0 / jnp.sqrt(jnp.asarray(lam))
            A_op = DenseOperator(A_op.to_dense() * inv_sqrt[None, :])
            tikhonov_inv_sqrt = inv_sqrt

        m = A_op.out_size
        probabilities = None
        precomputed_order = None
        sub_matrix_size = max(1, round(sub_matrix_fraction * m))
        if randomized:
            rn2 = A_op.row_norms_sq()
            probabilities = (rn2 / jnp.sum(rn2)).astype(jnp.float32)
            if precompute_order:
                p_np = np.asarray(probabilities, np.float64)
                p_np = p_np / p_np.sum()
                gen = np.random.default_rng(seed)
                precomputed_order = jnp.asarray(
                    np.stack(
                        [
                            gen.choice(m, size=sub_matrix_size, replace=False,
                                       p=p_np)
                            for _ in range(iterations)
                        ]
                    ),
                    jnp.int32,
                )

        # row visit order: cyclic or shuffled (the reference reseeds and
        # reshuffles at every init! with the same seed, Kaczmarz.jl:194-201 —
        # computing it once at construction is equivalent)
        if shuffle_rows and not randomized and not greedy_randomized:
            perm = jnp.asarray(
                np.random.default_rng(seed).permutation(m), jnp.int32
            )
        else:
            perm = jnp.arange(m, dtype=jnp.int32)

        greedy_B = greedy_norms = greedy_fnorm = None
        if greedy_randomized:
            if isinstance(normalize_reg, MeasurementBasedNormalization):
                raise ValueError(
                    "Measurement based regularization normalization is not "
                    "supported for Greedy Kaczmarz"
                )
            lam_s = jnp.asarray(0.0 if lam_is_vec else lam, jnp.float32)
            Ad = A_op.to_dense()
            rn2 = A_op.row_norms_sq()
            norms = rn2 + lam_s
            denom0 = jnp.where(rn2 > 0, 1.0 / norms, 0.0)
            B = Ad @ Ad.conj().T + lam_s * jnp.eye(m, dtype=Ad.dtype)
            greedy_B = B * denom0[None, :].astype(Ad.dtype)
            greedy_norms = norms
            greedy_fnorm = 1.0 / (jnp.sum(rn2) + lam_s)

        return cls(
            A=A_op,
            l2=l2,
            reg=tuple(other),
            probabilities=probabilities,
            greedy_B=greedy_B,
            greedy_norms=greedy_norms,
            greedy_fnorm=greedy_fnorm,
            tikhonov_inv_sqrt=tikhonov_inv_sqrt,
            theta=theta,
            perm=perm,
            precomputed_order=precomputed_order,
            normalize_reg=normalize_reg,
            randomized=randomized,
            sub_matrix_size=sub_matrix_size,
            shuffle_rows=shuffle_rows,
            greedy=greedy_randomized,
            seed=seed,
            iterations=iterations,
        )

    # -- protocol ----------------------------------------------------------
    def init(self, b, x0=None) -> KaczmarzState:
        b = jnp.asarray(b)
        m, n = self.A.out_size, self.A.in_size
        dt = b.dtype
        rdt = jnp.zeros((), dt).real.dtype

        scale = normalization_factor(self.normalize_reg, self.A, b).astype(rdt)
        lam = sink(self.l2).lam
        lam_is_vec = self.tikhonov_inv_sqrt is not None

        if lam_is_vec:
            lam_eff = jnp.asarray(1.0, rdt)  # λ=1 after standard-form transform
            eps_w = jnp.asarray(1.0, dt)
        else:
            lam_eff = (jnp.real(jnp.asarray(self.l2.get_lam())) * scale).astype(rdt)
            eps_w = jnp.sqrt(lam_eff).astype(dt)

        rn2 = self.A.row_norms_sq().astype(rdt)
        denom = jnp.where(rn2 > 0, 1.0 / (rn2 + lam_eff), 0.0)

        key = jax.random.PRNGKey(self.seed) if (self.randomized or self.greedy) else jnp.zeros((2,), jnp.uint32)

        if x0 is not None:
            x = jnp.broadcast_to(jnp.asarray(x0, dt), (n,))
        else:
            x = jnp.zeros((n,), dt)

        r = b - self.A.mv(x) if self.greedy else jnp.zeros((0,), dt)

        return KaczmarzState(
            u=b,
            x=x,
            vl=jnp.zeros((m,), dt),
            eps_w=eps_w,
            denom=denom,
            key=key,
            lam_scale=scale,
            iteration=jnp.asarray(0, jnp.int32),
            r=r,
        )

    # -- sweeps ------------------------------------------------------------
    def _row_update(self, carry, i, u, denom, eps_w):
        """One row projection (reference iterate_row_index, Kaczmarz.jl:303-308)."""
        x, vl = carry
        x, vl = kaczmarz_row_update(self.A, x, vl, i, u[i], denom[i], eps_w)
        return (x, vl), None

    def _standard_sweep(self, state: KaczmarzState):
        key = state.key
        if self.randomized and self.precomputed_order is not None:
            t = jnp.minimum(
                state.iteration, self.precomputed_order.shape[0] - 1
            )
            idx = lax.dynamic_index_in_dim(
                self.precomputed_order, t, keepdims=False
            )
        elif self.randomized:
            key, sub = jax.random.split(key)
            idx = jax.random.choice(
                sub,
                self.perm.shape[0],
                shape=(self.sub_matrix_size,),
                replace=False,
                p=self.probabilities,
            ).astype(jnp.int32)
        else:
            idx = self.perm

        (x, vl), _ = lax.scan(
            lambda c, i: self._row_update(c, i, state.u, state.denom, state.eps_w),
            (state.x, state.vl),
            idx,
        )
        return replace(state, x=x, vl=vl, key=key)

    def _greedy_sweep(self, state: KaczmarzState):
        """Greedy randomized sweep (reference Kaczmarz.jl:283-317, 393-426)."""
        rdt = state.denom.dtype
        fnorm = jnp.asarray(self.greedy_fnorm, rdt)
        norms = self.greedy_norms.astype(rdt)
        denom = state.denom

        def body(carry, key_j):
            x, vl, r = carry
            r_probs = jnp.abs(r) ** 2
            diff_numb = jnp.sum(r_probs)
            mx = jnp.max(r_probs * denom)
            if self.theta is None:
                e_k = 0.5 * (mx / diff_numb + fnorm)
            else:
                th = jnp.asarray(self.theta, rdt)
                e_k = th * (mx / diff_numb) + (1.0 - th) * fnorm
            lower = e_k * diff_numb
            r_probs = jnp.where(r_probs >= lower * norms, r_probs, 0.0)
            p = r_probs / jnp.sum(r_probs)
            row = jax.random.choice(key_j, r.shape[0], p=p).astype(jnp.int32)

            alpha = denom[row].astype(x.dtype) * r[row]
            x = self.A.row_axpy(x, row, alpha)
            vl = vl.at[row].add(alpha * state.eps_w)
            r = r - r[row] * self.greedy_B[:, row]
            return (x, vl, r), None

        key, sub = jax.random.split(state.key)
        keys = jax.random.split(sub, self.sub_matrix_size)
        (x, vl, r), _ = lax.scan(body, (state.x, state.vl, state.r), keys)
        return replace(state, x=x, vl=vl, r=r, key=key)

    def step(self, state: KaczmarzState) -> KaczmarzState:
        if self.greedy:
            state = self._greedy_sweep(state)
        else:
            state = self._standard_sweep(state)

        x = state.x
        for r in self.reg:
            lam = r.get_lam()
            if lam is None:
                x = r.prox(x)
            else:
                x = r.prox(x, lam * state.lam_scale.astype(jnp.real(lam).dtype))
        state = replace(state, x=x)

        if self.greedy:
            # recompute residual after prox (reference Kaczmarz.jl:294-297)
            r = state.u - state.eps_w * state.vl - self.A.mv(state.x)
            state = replace(state, r=r)

        return replace(state, iteration=state.iteration + 1)

    def done(self, state: KaczmarzState):
        return state.iteration >= self.iterations

    def solution(self, state: KaczmarzState):
        if self.tikhonov_inv_sqrt is not None:
            # undo the standard-form transform (reference Kaczmarz.jl:257-259)
            return state.x * self.tikhonov_inv_sqrt.astype(state.x.dtype)
        return state.x

    def convergence(self, state: KaczmarzState) -> dict:
        res = jnp.linalg.norm(self.A.mv(self.solution(state)) - state.u)
        return {"residual": res}
