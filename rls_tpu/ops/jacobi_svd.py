"""Batched one-sided Jacobi SVD / SVT for the nuclear / LLR proxes
(reference ProxNuclear.jl:26-31, ProxLLR.jl:43-88).

Classic one-sided Jacobi: every rotation is column dot products + axpys —
elementwise/reduction ops that stay f32 whatever the matmul unit rounds —
and the ONLY matmul is the final `W Vᵀ` reconstruction, done with the
hi/lo compensated stacked form (`_precise.mm_both`). The CPU tests hold
it to CPU f64 LAPACK for the small blocks LLR/nuclear need. Whether it
beats the device's batched `jnp.linalg.svd` is not measured.

Design points:
  * fixed sweep count (quadratic convergence; no data-dependent control
    flow),
  * round-robin tournament ordering: each step rotates n/2 DISJOINT
    column pairs simultaneously as one batched gather → rotate →
    inverse-gather, so a sweep is n−1 vectorized steps instead of
    n(n−1)/2 sequential ones,
  * everything broadcasts over arbitrary leading batch dims — the whole
    LLR block set is one call.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
from jax import lax

from ._precise import mm_both

__all__ = ["jacobi_svd", "jacobi_svdvals", "svt_jacobi", "default_sweeps"]


def _round_robin_schedule(n: int):
    """n−1 rounds of n/2 disjoint pairs covering every column pair once."""
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        rounds.append(
            [(players[i], players[n - 1 - i]) for i in range(n // 2)]
        )
        players = [players[0], players[-1]] + players[1:-1]
    return rounds


def default_sweeps(n: int) -> int:
    """Enough fixed sweeps for f32 convergence (quadratic once ordering
    sets in; small matrices settle in ~6)."""
    return max(6, int(math.ceil(math.log2(max(n, 2)))) + 4)


def _round_step(W, V, Wp, Wq, take, top, bot, inv):
    """One tournament round: rotate every disjoint (p, q) column pair so
    the (p, q) Gram entry vanishes (Brent–Luk)."""
    app = jnp.sum(Wp * Wp, axis=-2)
    aqq = jnp.sum(Wq * Wq, axis=-2)
    apq = jnp.sum(Wp * Wq, axis=-2)
    apq_safe = jnp.where(apq == 0, 1.0, apq)
    zeta = (aqq - app) / (2.0 * apq_safe)
    # sign(0) must be 1 (t = tan 45°), else equal-column pairs
    # (ζ = 0, apq ≠ 0) would never rotate
    sgn = jnp.where(zeta >= 0, 1.0, -1.0)
    t = sgn / (jnp.abs(zeta) + jnp.sqrt(1.0 + zeta * zeta))
    t = jnp.where(apq == 0, 0.0, t)
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = c * t
    c = c[..., None, :]
    s = s[..., None, :]

    def rotate(M, Mp, Mq):
        Mp2 = c * Mp - s * Mq
        Mq2 = s * Mp + c * Mq
        return take(jnp.concatenate([Mp2, Mq2], axis=-1), inv)

    return (
        rotate(W, Wp, Wq),
        rotate(V, take(V, top), take(V, bot)),
    )


def _jacobi_w_v(a, sweeps, unroll: bool | None = None):
    """Shared sweep loop: returns (W, V) with a = W Vᵀ, W's columns
    orthogonal (U·diag(s)) and V orthogonal.

    ``unroll=None`` defaults to the `lax.scan` path at EVERY size: a scan
    over the sweeps × (n−1) tournament rounds with the index tables as
    scan inputs — identical math to the Python-unrolled loop, but the
    round body compiles ONCE instead of sweeps·(n−1) times, so the
    unrolled variant is strictly an OPT-IN (`unroll=True`) for callers
    that amortize one compile over very many executions."""
    *batch, m, n = a.shape
    dt = a.dtype
    n_pad = n + (n % 2)
    if n_pad != n:
        a = jnp.concatenate(
            [a, jnp.zeros((*batch, m, 1), dt)], axis=-1
        )
    W = a
    V = jnp.broadcast_to(jnp.eye(n_pad, dtype=dt), (*batch, n_pad, n_pad))
    rounds = _round_robin_schedule(n_pad)
    if sweeps is None:
        sweeps = default_sweeps(n)
    if unroll is None:
        unroll = False
    perms = []
    for pairs in rounds:
        top = [p for p, q in pairs]
        bot = [q for p, q in pairs]
        order = top + bot
        inv = [0] * n_pad
        for i, c in enumerate(order):
            inv[c] = i
        perms.append((top, bot, inv))

    if unroll:
        take = lambda M, idx: M[..., :, idx]
        for _ in range(sweeps):
            for top, bot, inv in perms:
                W, V = _round_step(
                    W, V, take(W, top), take(W, bot), take, top, bot, inv
                )
        return W, V, n_pad

    take = lambda M, idx: jnp.take(M, idx, axis=-1)
    TOP = jnp.asarray([p[0] for p in perms], jnp.int32)  # (R, n/2)
    BOT = jnp.asarray([p[1] for p in perms], jnp.int32)
    INV = jnp.asarray([p[2] for p in perms], jnp.int32)  # (R, n_pad)

    def body(carry, idx):
        W, V = carry
        top, bot, inv = idx
        W, V = _round_step(
            W, V, take(W, top), take(W, bot), take, top, bot, inv
        )
        return (W, V), None

    xs = (
        jnp.tile(TOP, (sweeps, 1)),
        jnp.tile(BOT, (sweeps, 1)),
        jnp.tile(INV, (sweeps, 1)),
    )
    (W, V), _ = lax.scan(body, (W, V), xs)
    return W, V, n_pad


def jacobi_svd(a, sweeps: int | None = None, unroll: bool | None = None):
    """Batched thin SVD of real `a` (..., m, n), m ≥ n recommended.
    Returns (u, s, vt) like `jnp.linalg.svd(full_matrices=False)`, with
    singular values sorted descending."""
    n = a.shape[-1]
    W, V, n_pad = _jacobi_w_v(a, sweeps, unroll)
    s = jnp.sqrt(jnp.sum(W * W, axis=-2))
    order = jnp.argsort(-s, axis=-1)
    s_sorted = jnp.take_along_axis(s, order, axis=-1)
    W = jnp.take_along_axis(W, order[..., None, :], axis=-1)
    V = jnp.take_along_axis(V, order[..., None, :], axis=-1)
    denom = jnp.where(s_sorted > 0, s_sorted, 1.0)
    u = W / denom[..., None, :]
    vt = jnp.swapaxes(V, -1, -2)
    return u[..., :, :n], s_sorted[..., :n], vt[..., :n, :n]


def jacobi_svdvals(a, sweeps: int | None = None, unroll: bool | None = None):
    """Batched singular values (descending) of real `a`."""
    n = a.shape[-1]
    W, _, _ = _jacobi_w_v(a, sweeps, unroll)
    s = jnp.sqrt(jnp.sum(W * W, axis=-2))
    return -jnp.sort(-s, axis=-1)[..., :n]


def svt_jacobi(a, lam, sweeps: int | None = None, unroll: bool | None = None):
    """Batched singular-value soft threshold of real `a` (..., m, n):
    U max(S−λ, 0) Vᵀ without forming U — the threshold rescales W's
    columns and one compensated matmul reconstructs W' Vᵀ."""
    n = a.shape[-1]
    W, V, n_pad = _jacobi_w_v(a, sweeps, unroll)
    s2 = jnp.sum(W * W, axis=-2)
    s = jnp.sqrt(s2)
    scale = jnp.maximum(s - lam, 0.0) / jnp.where(s > 0, s, 1.0)
    out = mm_both(W * scale[..., None, :], jnp.swapaxes(V, -1, -2))
    return out[..., :, :n]
