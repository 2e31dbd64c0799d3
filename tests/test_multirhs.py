"""Multi-RHS batched solving ≡ per-column solves for every solver, mirroring
/root/reference/test/testMultiThreading.jl:1-29 (the vmapped active-mask
scheduler replaces SequentialState/MultiThreadingState)."""

import jax
import jax.numpy as jnp

import numpy as np
import pytest

import rls_tpu as rt
from rls_tpu import solve, solve_batched

SOLVERS = [
    "Kaczmarz",
    "CGNR",
    "FISTA",
    "OptISTA",
    "POGM",
    "ADMM",
    "SplitBregman",
    "DirectSolver",
    "PseudoInverse",
]

L2_ONLY = {"Kaczmarz", "CGNR", "DirectSolver", "PseudoInverse"}


@pytest.mark.parametrize("name", SOLVERS)
def test_batched_equals_columnwise(rng, name):
    Am = jnp.asarray(rng.normal(size=(8, 5)).astype(np.float32))
    X = jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32))
    B = Am @ X
    reg = (
        rt.L2Regularization(1e-4) if name in L2_ONLY else rt.L1Regularization(1e-4)
    )
    # compensated matvecs: where matmul inputs are rounded below f32 the
    # batched and single solves would otherwise round differently
    A = rt.DenseOperator(Am, compensated=True)
    s = rt.create_linear_solver(name, A, reg=reg, iterations=30, kwarg_warning=False)
    XB = solve_batched(s, B)
    assert XB.shape == (5, 3)
    atol = 2e-3
    for k in range(3):
        xk = solve(s, B[:, k])
        np.testing.assert_allclose(
            np.asarray(XB[:, k]), np.asarray(xk), atol=atol,
            err_msg=f"{name} column {k}",
        )


def test_batched_after_single(rng):
    """A solver config is stateless: single solve after batched solve works
    unchanged (reference tests sequential-after-batched state restoration)."""
    Am = jnp.asarray(rng.normal(size=(8, 5)).astype(np.float32))
    x = jnp.asarray(rng.normal(size=(5,)).astype(np.float32))
    b = Am @ x
    s = rt.FISTA.create(rt.DenseOperator(Am, compensated=True),
                        reg=rt.L1Regularization(1e-4), iterations=30)
    B = jnp.stack([b, 2 * b], axis=1)
    XB = solve_batched(s, B)
    x1 = solve(s, b)
    np.testing.assert_allclose(np.asarray(XB[:, 0]), np.asarray(x1), atol=2e-3)


def test_custom_scheduler_seam(rng):
    """The user-pluggable scheduler hook (reference solve!(…; scheduler=…),
    MultiThreading.jl:19-43 / howto/multi_threading.jl:45-67): a custom
    chunked policy and a fixed-budget lax.scan policy must reach the
    default masked-vmap policy's solution."""
    A = jnp.asarray(rng.normal(size=(32, 16)).astype(np.float32))
    X = jnp.asarray(rng.normal(size=(16, 5)).astype(np.float32))
    B = A @ X
    s = rt.CGNR.create(A, reg=rt.L2Regularization(1e-6), iterations=30)

    def chunked(slv, states, active0):
        K = active0.shape[0]
        outs = []
        for lo in range(0, K, 2):
            hi = min(lo + 2, K)
            chunk = jax.tree.map(lambda x: x[lo:hi], states)
            outs.append(rt.masked_vmap_scheduler(slv, chunk, active0[lo:hi]))
        return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *outs)

    def fixed_budget(slv, states, active0):
        vstep = jax.vmap(slv.step)
        states, _ = jax.lax.scan(
            lambda st, _: (vstep(st), None), states, None,
            length=s.iterations)
        return states

    X_def = solve_batched(s, B)
    X_chu = solve_batched(s, B, scheduler=chunked)
    X_bud = solve_batched(s, B, scheduler=fixed_budget)
    nrm = float(jnp.linalg.norm(X_def))
    assert float(jnp.linalg.norm(X_chu - X_def)) / nrm < 1e-6
    assert float(jnp.linalg.norm(X_bud - X_def)) / nrm < 1e-5
