"""Row-action solving with Kaczmarz and its randomized variants
(reference docs/src/literate/howto/efficient_kaczmarz.jl).

The reference optimizes row access by transposed storage + SIMD; here the
row recurrence runs as a `lax.scan` over dynamically gathered rows, and
`time_solver` replaces BenchmarkTools.
"""

import jax
import jax.numpy as jnp
import numpy as np

import rls_tpu as rt

rng = np.random.default_rng(0)
A = jnp.asarray(rng.normal(size=(200, 64)).astype(np.float32))
x_true = jnp.asarray(rng.normal(size=(64,)).astype(np.float32))
b = A @ x_true

for kw in [
    {},  # cyclic
    {"shuffle_rows": True},
    {"randomized": True, "sub_matrix_fraction": 0.5},
    {"greedy_randomized": True},
]:
    solver = rt.Kaczmarz.create(A, reg=rt.L2Regularization(1e-6), iterations=20, **kw)
    stats = rt.time_solver(jax.jit(rt.solve), solver, b, reps=3)
    x = rt.solve(solver, b)
    err = float(jnp.linalg.norm(x - x_true) / jnp.linalg.norm(x_true))
    print(f"{kw or 'cyclic'}: rel_err={err:.2e} mean_time={stats['mean_s']*1e3:.1f} ms")

# vector-λ Tikhonov (standard-form transform, solution auto-rescaled)
lam_vec = jnp.asarray(rng.uniform(0.5, 2.0, size=(64,)), jnp.float32) * 1e-6
solver = rt.Kaczmarz.create(A, reg=rt.L2Regularization(lam_vec), iterations=20)
x = rt.solve(solver, b)
print("vector-λ rel. error:", float(jnp.linalg.norm(x - x_true) / jnp.linalg.norm(x_true)))

# batched fixed-iteration solve with the randomized row order precomputed
# at construction (a table lookup instead of in-loop sampling)
solver = rt.Kaczmarz.create(
    A, reg=rt.L2Regularization(1e-6), iterations=20,
    randomized=True, sub_matrix_fraction=0.5, precompute_order=True,
)
X = rt.solve_batched_fast(solver, b[:, None])
err = float(jnp.linalg.norm(X[:, 0] - x_true) / jnp.linalg.norm(x_true))
print(f"batched randomized: rel_err={err:.2e}")

# sparse systems: PaddedCSROperator gives O(nnz_row) row actions (the
# reference's CSC dot_with_matrix_row / kaczmarz_update! fast paths) —
# a sweep costs O(m·k_max) instead of the dense O(m·n)
import numpy as np  # noqa: E402

A_np = np.asarray(A)
A_sp = A_np.copy()
A_sp[np.random.default_rng(0).uniform(size=A_sp.shape) < 0.7] = 0.0
b_sp = jnp.asarray(A_sp) @ x_true
solver = rt.Kaczmarz.create(
    rt.PaddedCSROperator.from_dense(A_sp), reg=rt.L2Regularization(1e-6),
    iterations=30,
)
x = rt.solve(solver, b_sp)
print("padded-CSR sparse rel_err:",
      float(jnp.linalg.norm(x - x_true) / jnp.linalg.norm(x_true)))

# ...and sparse storage in the batched randomized mode
solver = rt.Kaczmarz.create(
    rt.PaddedCSROperator.from_dense(A_sp), reg=rt.L2Regularization(1e-6),
    iterations=30, randomized=True, sub_matrix_fraction=0.5,
    precompute_order=True,
)
Xs = rt.solve_batched_fast(solver, b_sp[:, None])
print("padded-CSR batched rel_err:",
      float(jnp.linalg.norm(Xs[:, 0] - x_true) / jnp.linalg.norm(x_true)))

# greedy-randomized mode (residual-driven e_k-thresholded sampling,
# reference Kaczmarz.jl:393-426), batched
solver = rt.Kaczmarz.create(
    A, reg=rt.L2Regularization(1e-6), iterations=12,
    greedy_randomized=True, sub_matrix_fraction=0.25,
)
Xg = rt.solve_batched_fast(solver, b[:, None])
print("greedy batched rel_err:",
      float(jnp.linalg.norm(Xg[:, 0] - x_true) / jnp.linalg.norm(x_true)))
