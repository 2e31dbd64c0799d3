"""`solve_batched_fast`: shapes, agreement with the unrolled and masked
drivers, one compilation per solver structure, and use under jit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rls_tpu as rt
from rls_tpu.models.solvers.base import _solve_batched_unrolled_jit


def _solver(rng, m=10, n=6, lam=1e-3):
    A = jnp.asarray(rng.normal(size=(m, n)), jnp.float32)
    return rt.FISTA.create(A, reg=rt.L1Regularization(lam), iterations=12,
                           track_residual=False), A


@pytest.mark.parametrize("K", [1, 2, 5])
def test_shape_and_agreement(rng, K):
    s, A = _solver(rng)
    B = A @ jnp.asarray(rng.normal(size=(6, K)), jnp.float32)
    X = rt.solve_batched_fast(s, B)
    assert X.shape == (6, K) and X.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(X),
                               np.asarray(rt.solve_batched_unrolled(s, B)), atol=1e-6)
    # fixed iteration count and no residual tracking: the masked
    # while-loop driver runs the same steps
    np.testing.assert_allclose(np.asarray(X), np.asarray(rt.solve_batched(s, B)),
                               atol=1e-5)


def test_accepts_numpy_batches(rng):
    s, A = _solver(rng)
    B = np.asarray(A @ jnp.ones((6, 3), jnp.float32))
    assert rt.solve_batched_fast(s, B).shape == (6, 3)


def test_one_compilation_per_solver_structure(rng):
    """Solvers differing only in array values (λ, A) reuse one compiled
    program: the solver is a traced argument, not a closure constant."""
    B = jnp.asarray(rng.normal(size=(10, 4)), jnp.float32)
    s1, _ = _solver(rng, lam=1e-3)
    rt.solve_batched_fast(s1, B)
    before = _solve_batched_unrolled_jit._cache_size()
    s2, _ = _solver(rng, lam=5e-2)
    rt.solve_batched_fast(s2, B)
    assert _solve_batched_unrolled_jit._cache_size() == before


def test_nests_under_jit(rng):
    s, A = _solver(rng)
    B = A @ jnp.asarray(rng.normal(size=(6, 3)), jnp.float32)
    X = jax.jit(lambda B_: rt.solve_batched_fast(s, B_))(B)
    np.testing.assert_allclose(np.asarray(X), np.asarray(rt.solve_batched_fast(s, B)),
                               atol=1e-6)


def test_runs_every_nested_step(rng):
    """SplitBregman's outer × inner steps all run (total_steps, not
    iterations): one outer iteration differs from two."""
    A = jnp.asarray(rng.normal(size=(12, 8)), jnp.float32)
    B = A @ jnp.asarray(rng.normal(size=(8, 2)), jnp.float32)
    kw = dict(reg=rt.L1Regularization(1e-3), iterations_inner=3, iterations_cg=4)
    one = rt.solve_batched_fast(rt.SplitBregman.create(A, iterations=1, **kw), B)
    two = rt.solve_batched_fast(rt.SplitBregman.create(A, iterations=2, **kw), B)
    assert float(jnp.max(jnp.abs(one - two))) > 1e-6
