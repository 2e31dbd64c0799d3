"""Custom batch scheduling for multi-RHS solves.

The reference exposes a user-pluggable scheduler seam on matrix
right-hand sides: ``solve!(solver, B; scheduler=MultiThreadingState)``
and the custom-``SpawnState`` recipe
(/root/reference/src/MultiThreading.jl:19-43,
docs/src/literate/howto/multi_threading.jl:45-67). `solve_batched`
mirrors that seam: ``scheduler`` is any callable

    scheduler(solver, states, active0) -> final_states

where ``states`` is the vmap-stacked per-problem state pytree and
``active0`` the (K,) liveness mask (see
`rls_tpu.masked_vmap_scheduler`, the default policy). Because solver
states are pure pytrees and `step`/`done` pure functions, a scheduler
can advance problems in any order or grouping — no thread pools needed;
on an accelerator the scheduling question becomes "which problems share
a compiled step" rather than "which core runs which loop".

This example builds two custom policies and checks both reach the
default policy's solution:

  * a CHUNKED scheduler — problems advance in chunks of ``c`` columns,
    each chunk stepped to convergence before the next starts (the
    reference's SequentialState, lifted to chunks). Useful when K is too
    large for one vmapped state to fit memory.
  * a FIXED-BUDGET scheduler — every problem takes exactly ``n`` steps
    via `lax.scan` with no convergence reduction at all (no `any(active)`
    collective; the fastest shape when iteration counts are uniform).
"""

import jax
import jax.numpy as jnp
import numpy as np

import rls_tpu as rt
from rls_tpu.models.solvers.base import tree_where

rng = np.random.default_rng(0)
A = jnp.asarray(rng.normal(size=(48, 24)).astype(np.float32))
X = jnp.asarray(rng.normal(size=(24, 8)).astype(np.float32))
B = A @ X  # 8 problems as columns

solver = rt.CGNR.create(A, reg=rt.L2Regularization(1e-6), iterations=40)


def chunked_scheduler(c):
    """Advance problems in chunks of ``c``: chunk i runs to convergence
    (via the default masked-vmap policy) before chunk i+1 starts."""

    def schedule(slv, states, active0):
        K = active0.shape[0]
        outs = []
        for lo in range(0, K, c):
            hi = min(lo + c, K)
            chunk = jax.tree.map(lambda x: x[lo:hi], states)
            outs.append(
                rt.masked_vmap_scheduler(slv, chunk, active0[lo:hi])
            )
        return jax.tree.map(
            lambda *xs: jnp.concatenate(xs, axis=0), *outs
        )

    return schedule


def fixed_budget_scheduler(n_steps):
    """Exactly ``n_steps`` vmapped steps for every problem — a lax.scan
    with no convergence mask (and therefore no any() reduction)."""

    def schedule(slv, states, active0):
        vstep = jax.vmap(slv.step)

        def body(s, _):
            return vstep(s), None

        states, _ = jax.lax.scan(body, states, None, length=n_steps)
        return states

    return schedule


X_default = rt.solve_batched(solver, B)
X_chunked = rt.solve_batched(solver, B, scheduler=chunked_scheduler(3))
X_budget = rt.solve_batched(
    solver, B, scheduler=fixed_budget_scheduler(solver.iterations)
)

err_c = float(jnp.linalg.norm(X_chunked - X_default) / jnp.linalg.norm(X_default))
err_b = float(jnp.linalg.norm(X_budget - X_default) / jnp.linalg.norm(X_default))
err_x = float(jnp.linalg.norm(X_default - X) / jnp.linalg.norm(X))
print("chunked vs default:", err_c)
print("fixed-budget vs default:", err_b)
print("default vs truth:", err_x)
assert err_c < 1e-5, "chunked scheduler diverged from the default policy"
assert err_b < 1e-5, "fixed-budget scheduler diverged from the default policy"
assert err_x < 1e-3, "solve did not converge"

# a custom schedule can also interleave: tree_where freezes any subset
# per step, e.g. priority-serving the worst-residual problems first —
# the mask mechanics the default policy uses are public:
_ = tree_where  # (see masked_vmap_scheduler's body for the pattern)
