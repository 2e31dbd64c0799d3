"""Solver protocol and drivers.

JAX redesign of the reference's solver layer
(/root/reference/src/RegularizedLeastSquares.jl:21-131): Julia's
"mutable solver + mutable state + iterator protocol" becomes

  * solver  = frozen pytree config (operators, reg terms, traced scalars,
    static iteration limits),
  * state   = frozen pytree of arrays produced by ``solver.init(b)``
    (the reference's `init!` re-materialization seam, FISTA.jl:94-103 — here
    device/sharding placement follows `b` automatically),
  * step    = pure ``state -> state`` — the reference's `iterate`,
  * drivers = `solve` (jit + lax.while_loop), `solve_trace`
    (lax.scan, per-iteration metrics — the jit-friendly callback analog),
    `solve_with_callbacks` (host loop, exact reference callback semantics),
    `solve_batched` (vmap + active-mask — the reference's multi-RHS
    scheduler, MultiThreading.jl).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from jax import lax

from ..._pytree import pytree_dataclass, static_field
from ...ops.base import LinearOperator, NormalOperator, as_operator
from ..regularization import (
    ParameterizedRegularization,
    ProjectionRegularization,
    Regularization,
    find_sinks,
    normalization_factor,
    sink,
)

__all__ = [
    "LinearSolver",
    "solve",
    "solve_trace",
    "solve_with_callbacks",
    "solve_batched",
    "solve_unrolled",
    "solve_batched_unrolled",
    "solve_batched_fast",
    "pcg",
    "tree_where",
    "kaczmarz_row_update",
    "split_projection_terms",
    "prepare_operators",
    "SolverRun",
]


# --------------------------------------------------------------------------
# solver protocol
# --------------------------------------------------------------------------


class LinearSolver:
    """Protocol for all solvers. Subclasses are pytree dataclasses."""

    iterations: int

    # construction hook used by the registry (mirrors createLinearSolver)
    @classmethod
    def create(cls, A=None, **kwargs) -> "LinearSolver":
        raise NotImplementedError

    def init(self, b, x0=None):
        raise NotImplementedError

    def step(self, state):
        raise NotImplementedError

    def done(self, state):
        raise NotImplementedError

    def solution(self, state):
        return state.x

    def finalize(self, state):
        """Post-loop hook (e.g. CGNR applies its projections once at the
        end, reference CGNR.jl:144-148)."""
        return state

    @property
    def total_steps(self) -> int:
        """Number of step() calls a full fixed-iteration solve needs.
        Equals `iterations` for single-loop solvers; nested-loop solvers
        (SplitBregman: outer Bregman × inner ADMM) override it. Used by
        the unrolled drivers — `iterations` alone under-runs them."""
        return self.iterations

    def convergence(self, state) -> dict:
        """Named convergence metrics (reference ``solverconvergence``)."""
        return {}


# --------------------------------------------------------------------------
# shared construction helpers
# --------------------------------------------------------------------------


def split_projection_terms(reg):
    """Split a reg spec into (parameterized_terms, projection_terms),
    mirroring the `findsinks(AbstractProjectionRegularization, reg)` pattern
    in every solver ctor (e.g. FISTA.jl:79-87)."""
    regs = list(reg) if isinstance(reg, (list, tuple)) else [reg]
    proj_idx = set(find_sinks(ProjectionRegularization, regs))
    proj = tuple(regs[i] for i in sorted(proj_idx))
    params = [r for i, r in enumerate(regs) if i not in proj_idx]
    return params, proj


def prepare_operators(A, AHA):
    """Normalize (A, AHA) inputs: accept raw matrices, default AHA = AᴴA."""
    A_op = as_operator(A) if A is not None else None
    if AHA is None:
        if A_op is None:
            raise ValueError("either A or AHA must be supplied")
        AHA_op = NormalOperator(A_op)
    else:
        AHA_op = as_operator(AHA)
    return A_op, AHA_op


def kaczmarz_row_update(A, x, dual, j, rhs, denom_j, eps_w_j):
    """One regularized Kaczmarz row projection — the shared algebra of
    Kaczmarz._row_update, DaxKaczmarz.step, and DaxConstrained.row_sweep
    (reference iterate_row_index, Kaczmarz.jl:303-308):

        τ      = a_j · x            (unconjugated, BLAS dotu semantics)
        α      = denom_j (rhs − τ − εw_j · dual_j)
        x     += α · conj(a_j)
        dual_j += α · εw_j

    Routed through the operator's `row_dot`/`row_axpy` so sparse
    operators (PaddedCSROperator) pay O(nnz_row) per update instead of a
    dense O(n·nnz) masked gather (reference CSC specializations,
    Utils.jl:96-105, Kaczmarz.jl:532-539).
    """
    tau = A.row_dot(j, x)
    alpha = denom_j.astype(x.dtype) * (
        rhs - tau - eps_w_j.astype(x.dtype) * dual[j]
    )
    x = A.row_axpy(x, j, alpha)
    dual = dual.at[j].add(alpha * eps_w_j.astype(x.dtype))
    return x, dual


def tree_where(mask, new_tree, old_tree):
    """Select between two identical pytrees; `mask` is a scalar bool or a
    batch vector matching the leading axis of every leaf."""

    def sel(a, b):
        m = mask
        if m.ndim > 0 and a.ndim > m.ndim:
            m = m.reshape(m.shape + (1,) * (a.ndim - m.ndim))
        return jnp.where(m, a, b)

    return jax.tree_util.tree_map(sel, new_tree, old_tree)


# --------------------------------------------------------------------------
# preconditioned conjugate gradient (inner solver for ADMM/SplitBregman)
# --------------------------------------------------------------------------


def pcg(
    matvec,
    b,
    x0,
    maxiter: int,
    reltol,
    precon: Optional[Callable] = None,
    unroll: bool = False,
):
    """Preconditioned CG on a hermitian PSD `matvec`, early exit at
    ‖r‖ ≤ reltol·‖b‖. Native replacement for IterativeSolvers.cg!
    (reference ADMM.jl:244): the whole loop lives inside the jitted solver
    step, so all dot-product reductions fuse and shard with the operator.

    `unroll=True` replaces the `lax.while_loop` with a python-unrolled
    fixed-maxiter loop with MASKED updates (steps freeze once converged,
    with a guarded denominator so frozen steps stay finite) — the
    straight-line inner CG for the unrolled solve drivers."""
    P = precon if precon is not None else (lambda v: v)
    r0 = b - matvec(x0)
    z0 = P(r0)
    target = reltol * jnp.linalg.norm(b)

    def step(c, masked: bool):
        x, r, p, rz, i = c
        q = matvec(p)
        pq = jnp.vdot(p, q)
        if masked:
            active = jnp.linalg.norm(r) > target
            denom = jnp.where(pq == 0, 1.0, pq)
            alpha = jnp.where(active, rz / denom, 0.0).astype(x.dtype)
        else:
            alpha = rz / pq
        x = x + alpha * p
        r = r - alpha * q
        z = P(r)
        rz_new = jnp.vdot(r, z)
        if masked:
            beta = jnp.where(rz == 0, 0.0, rz_new / jnp.where(rz == 0, 1.0, rz))
            # freeze the search direction too: once converged, rz_new == rz
            # makes beta = 1 and p would grow by z every remaining step
            p = jnp.where(active, z + beta * p, p)
        else:
            beta = rz_new / rz
            p = z + beta * p
        return (x, r, p, rz_new, i + 1)

    init = (x0, r0, z0, jnp.vdot(r0, z0), 0)
    if unroll:
        c = init
        for _ in range(maxiter):
            c = step(c, masked=True)
        return c[0]

    def cond(c):
        _, r, _, _, i = c
        return jnp.logical_and(i < maxiter, jnp.linalg.norm(r) > target)

    x, *_ = lax.while_loop(cond, lambda c: step(c, masked=False), init)
    return x


# --------------------------------------------------------------------------
# drivers
# --------------------------------------------------------------------------


def _as_split_real(solver):
    """Return the SplitRealSolver view of `solver`, or None. Lazy import:
    split_real imports prox which imports this module's package."""
    from ..split_real import SplitRealSolver

    return solver if isinstance(solver, SplitRealSolver) else None


def solve(solver: LinearSolver, b, x0=None):
    """Full solve under one jittable computation: init → while(¬done) step →
    finalize → solution. Mirrors `solve!` (reference
    RegularizedLeastSquares.jl:103-117) without callbacks.

    A matrix ``b`` (m × K) dispatches to :func:`solve_batched` — the
    reference routes `solve!(solver, B::AbstractMatrix)` through the
    same entry point via its scheduler layer
    (/root/reference/src/MultiThreading.jl:30-43).

    A :class:`~rls_tpu.models.split_real.SplitRealSolver` (the auto twin
    of a complex problem on complex-free runtimes) embeds ``b``
    host-side, solves the real twin, and returns numpy complex64."""
    sr = _as_split_real(solver)
    if sr is not None:
        if x0 is None:
            xs = jax.jit(lambda bb: solve(sr.inner, bb))(sr.embed_b(b))
        else:
            xs = jax.jit(lambda bb, xx: solve(sr.inner, bb, xx))(
                sr.embed_b(b), sr.embed_b(x0))
        return sr.assemble(xs)
    b = jnp.asarray(b)
    if b.ndim == 2:
        return solve_batched(solver, b, x0)
    state = solver.init(b, x0)
    state = lax.while_loop(
        lambda s: jnp.logical_not(solver.done(s)), solver.step, state
    )
    state = solver.finalize(state)
    return solver.solution(state)


def solve_trace(solver: LinearSolver, b, x0=None, metrics: bool = True):
    """Fixed-length scan over `solver.iterations` with done-masking.

    Returns ``(x, trace)`` where trace stacks per-iteration
    ``(solution, convergence-metrics, active-flag)`` — the jit-friendly
    equivalent of StoreSolutionCallback/StoreConvergenceCallback
    (reference Callbacks.jl)."""
    state0 = solver.init(b, x0)

    def body(state, _):
        active = jnp.logical_not(solver.done(state))
        new = solver.step(state)
        state = tree_where(active, new, state)
        out = (solver.solution(state),)
        if metrics:
            out += (solver.convergence(state),)
        out += (active,)
        return state, out

    state, trace = lax.scan(body, state0, None, length=solver.total_steps)
    state = solver.finalize(state)
    return solver.solution(state), trace


def solver_solution(solver: LinearSolver, state):
    """Reference ``solversolution`` accessor."""
    return solver.solution(state)


def solver_convergence(solver: LinearSolver, state):
    """Reference ``solverconvergence`` accessor."""
    return solver.convergence(state)


def solve_unrolled(solver: LinearSolver, b, x0=None):
    """Fixed-iteration solve with a python-unrolled step loop — a single
    straight-line XLA program with no control-flow primitives.

    Use cases: (a) fixed-iteration throughput benchmarking, (b) small
    iteration counts where unrolling lets XLA fuse across iterations. No
    early convergence exit — runs exactly `solver.total_steps` steps (a
    straight-line program also wants a control-flow-free prox, e.g.
    TVRegularization(unroll=True))."""
    sr = _as_split_real(solver)
    if sr is not None:
        if x0 is None:
            xs = jax.jit(lambda bb: solve_unrolled(sr.inner, bb))(
                sr.embed_b(b))
        else:
            xs = jax.jit(lambda bb, xx: solve_unrolled(sr.inner, bb, xx))(
                sr.embed_b(b), sr.embed_b(x0))
        return sr.assemble(xs)
    state = solver.init(b, x0)
    for _ in range(solver.total_steps):
        state = solver.step(state)
    state = solver.finalize(state)
    return solver.solution(state)


def solve_batched_unrolled(solver: LinearSolver, B, x0=None):
    """vmapped `solve_unrolled` over the columns of B; returns n × K."""
    sr = _as_split_real(solver)
    if sr is not None:
        x0e = None if x0 is None else sr.embed_b(x0)
        xs = jax.jit(lambda BB: solve_batched_unrolled(sr.inner, BB, x0e))(
            sr.embed_b(B))
        return sr.assemble(xs)
    B = jnp.asarray(B)
    if x0 is None:
        fn = lambda col: solve_unrolled(solver, col)
    else:
        fn = lambda col: solve_unrolled(solver, col, x0)
    return jax.vmap(fn)(B.T).T


_solve_batched_unrolled_jit = jax.jit(solve_batched_unrolled)


def solve_batched_fast(solver: LinearSolver, B):
    """Batched fixed-iteration solve of the columns of ``B`` (m × K):
    `solve_batched_unrolled` as one jitted straight-line XLA program.
    Every problem runs exactly ``solver.total_steps`` steps (no early
    exit), so the whole batch costs one dispatch. The solver is a traced
    argument: solvers that differ only in array values share one
    compilation per batch shape."""
    sr = _as_split_real(solver)
    if sr is not None:
        return sr.assemble(_solve_batched_unrolled_jit(sr.inner, sr.embed_b(B)))
    return _solve_batched_unrolled_jit(solver, jnp.asarray(B))


class SolverRun:
    """Host-side view passed to callbacks — gives `solution`, `convergence`
    and raw `state` access like the reference's callback(solver, iteration)
    protocol."""

    def __init__(self, solver: LinearSolver, state):
        self.solver = solver
        self.state = state

    @property
    def solution(self):
        return self.solver.solution(self.state)

    @property
    def convergence(self):
        return self.solver.convergence(self.state)


def solve_with_callbacks(solver: LinearSolver, b, callbacks=None, x0=None):
    """Host-loop driver with per-iteration Python callbacks; exact analog of
    `solve!(solver, b; callbacks)` (reference RegularizedLeastSquares.jl:103-117),
    including the iteration-0 invocation."""
    if callbacks is None:
        callbacks = []
    elif callable(callbacks):
        callbacks = [callbacks]

    step = jax.jit(lambda s: solver.step(s))
    done = jax.jit(lambda s: solver.done(s))

    verbose = bool(getattr(solver, "verbose", False))

    state = solver.init(b, x0)
    run = SolverRun(solver, state)
    for cb in callbacks:
        cb(run, 0)

    iteration = 0
    while not bool(done(state)):
        state = step(state)
        run.state = state
        iteration += 1
        if verbose:
            metrics = {
                k: (float(v) if jnp.ndim(v) == 0 else [float(x) for x in v])
                for k, v in solver.convergence(state).items()
            }
            print(f"Iteration {iteration}; {metrics}")
        for cb in callbacks:
            cb(run, iteration)

    state = solver.finalize(state)
    run.state = state
    return solver.solution(state)


def masked_vmap_scheduler(solver: LinearSolver, states, active0):
    """Default `solve_batched` scheduling policy: one masked-vmap step of
    EVERY still-active problem per outer iteration, inside a jittable
    `lax.while_loop` — the JAX replacement of the reference's
    SequentialState/MultiThreadingState schedulers
    (/root/reference/src/MultiThreading.jl:52-78). Finished problems are
    frozen via masked updates.

    Scheduler contract (the custom-scheduling seam, mirroring the
    reference's ``solve!(solver, B; scheduler=...)`` extension point,
    /root/reference/docs/src/literate/howto/multi_threading.jl:45-67):
    a scheduler is ``f(solver, states, active0) -> final_states`` where
    ``states`` is the vmap-stacked per-problem state pytree (leading axis
    = problem index) and ``active0`` the (K,) initial liveness mask. It
    must return the stacked states after every problem has converged (or
    its budget is spent); `solve_batched` applies `finalize`/`solution`
    per problem afterwards. Custom schedulers may step problems in any
    order or grouping — chunked, priority-ordered, device-pinned — using
    `jax.vmap(solver.step)` / `jax.vmap(solver.done)` or per-problem
    `solver.step` directly (see examples/custom_scheduler.py)."""
    vstep = jax.vmap(solver.step)
    vdone = jax.vmap(solver.done)

    def cond(carry):
        _, active = carry
        return jnp.any(active)

    def body(carry):
        states, active = carry
        new = vstep(states)
        states = tree_where(active, new, states)
        active = jnp.logical_and(active, jnp.logical_not(vdone(states)))
        return states, active

    states, _ = lax.while_loop(cond, body, (states, active0))
    return states


def solve_batched(solver: LinearSolver, B, x0=None, scheduler=None):
    """Multi-RHS solve: columns of ``B`` (m × K) are independent problems.

    ``scheduler`` (default `masked_vmap_scheduler`) controls how the
    per-problem states advance — the user-pluggable batch-scheduling seam
    mirroring the reference's ``solve!(solver, B; scheduler=...)``
    (/root/reference/src/MultiThreading.jl:19-43,
    docs/src/literate/howto/multi_threading.jl:45-67). See
    `masked_vmap_scheduler` for the contract and
    examples/custom_scheduler.py for a worked custom policy.
    Returns an n × K matrix (reference hcat gather)."""
    sr = _as_split_real(solver)
    if sr is not None:
        x0e = None if x0 is None else sr.embed_b(x0)
        xs = jax.jit(
            lambda BB: solve_batched(sr.inner, BB, x0e, scheduler=scheduler)
        )(sr.embed_b(B))
        return sr.assemble(xs)
    if scheduler is None:
        scheduler = masked_vmap_scheduler
    B = jnp.asarray(B)
    K = B.shape[1]

    if x0 is None:
        init_fn = lambda col: solver.init(col)
    else:
        init_fn = lambda col: solver.init(col, x0)
    states = jax.vmap(init_fn)(B.T)
    active0 = jnp.ones((K,), bool)

    states = scheduler(solver, states, active0)
    states = jax.vmap(solver.finalize)(states)
    xs = jax.vmap(solver.solution)(states)  # (K, n)
    return xs.T
