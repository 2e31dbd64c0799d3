"""Device placement — the analog of the reference's GPU-acceleration
howto (docs/src/literate/howto/gpu_acceleration.jl).

In the reference, moving a solve to the GPU means passing a GPU array `b`;
the state re-materializes with b's array type. Here the same seam exists:
`solver.init(b)` builds the state with b's device/sharding, so placing `b`
(and the operator payload) with `jax.device_put` moves the entire solve.
The same code runs on whatever device JAX's first device is.
"""

import jax
import jax.numpy as jnp
import numpy as np

import rls_tpu as rt

rng = np.random.default_rng(0)
dev = jax.devices()[0]
print("running on:", dev)

A = jax.device_put(jnp.asarray(rng.normal(size=(64, 32)).astype(np.float32)), dev)
x_true = jnp.asarray(rng.normal(size=(32,)).astype(np.float32))
b = jax.device_put(A @ x_true, dev)

solver = rt.FISTA.create(
    A, reg=rt.L1Regularization(1e-4), iterations=50, rel_tol=0.0
)

# jitted while-loop solve
x = jax.jit(rt.solve)(solver, b)
print("device of solution:", list(x.devices())[0])
print("rel. error:", float(jnp.linalg.norm(x - x_true) / jnp.linalg.norm(x_true)))

# timing utility (BenchmarkTools analog)
stats = rt.time_solver(jax.jit(rt.solve), solver, b)
print(f"compile {stats['compile_s']:.2f}s, mean solve {stats['mean_s']*1e3:.2f} ms")

# -- batched fixed-iteration solves ------------------------------------------
# solve_batched_fast runs a whole batch of problems as one straight-line
# XLA program (every problem runs the configured number of steps).
g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
kern = np.outer(g, g)
kern /= kern.sum()
sep = rt.SeparableConvOperator.from_kernel(kern, im_shape=(32, 32))
tv_solver = rt.FISTA.create(
    sep,
    reg=rt.TVRegularization(1e-3, shape=(32, 32), iterations_tv=5, unroll=True),
    iterations=20,
    rho=0.95,
    rel_tol=0.0,
    track_residual=False,
)
imgs = jnp.asarray(rng.normal(size=(4, 32 * 32)).astype(np.float32))
B = jax.vmap(sep.mv)(imgs).T
X = rt.solve_batched_fast(tv_solver, B)
print("batched FISTA-TV:", X.shape, "finite:", bool(jnp.isfinite(X).all()))
assert X.shape == (32 * 32, 4) and bool(jnp.isfinite(X).all())
