"""Image deblurring with ADMM + TV: ADMM with TV regularization, CG inner
solve, convolution operator.

ADMM applies the prox separately from the transform: use
reg = L1 on the gradient domain with reg_trafo = GradientOperator —
exactly the reference's documented pattern (ADMM.jl docstring:74).
"""

import jax
import jax.numpy as jnp
import numpy as np

import rls_tpu as rt

rng = np.random.default_rng(0)
N = 64

img = np.zeros((N, N), np.float32)
img[12:40, 20:52] = 1.0
img[30:55, 8:24] = 0.5
x_true = jnp.asarray(img.reshape(-1))

# Gaussian blur via the direct convolution operator
k = 7
ax = np.arange(k) - k // 2
g = np.exp(-(ax**2) / (2 * 1.5**2))
kern = np.outer(g, g)
kern /= kern.sum()
op = rt.DirectConvOperator(kernel=jnp.asarray(kern, jnp.float32), im_shape=(N, N))
b = op.mv(x_true) + 0.01 * jnp.asarray(rng.normal(size=(N * N,)), jnp.float32)

grad = rt.GradientOperator(im_shape=(N, N), _dtype=jnp.float32)
solver = rt.ADMM.create(
    op,
    reg=rt.L1Regularization(2e-3),
    reg_trafo=grad,
    rho=1e-1,
    iterations=30,
    iterations_cg=10,
)
x = jax.jit(rt.solve)(solver, b)
print("blurred rel. error:", float(jnp.linalg.norm(b - x_true) / jnp.linalg.norm(x_true)))
print("ADMM-TV rel. error:", float(jnp.linalg.norm(x - x_true) / jnp.linalg.norm(x_true)))
