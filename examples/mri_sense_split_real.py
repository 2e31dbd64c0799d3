"""Multi-coil SENSE MRI reconstruction in split real/imaginary form —
complex image, coil maps, and k-space all carried as f32, so the whole
pipeline runs on runtimes without FFT or complex support.

The measurement model is `A = stack_c (M ∘ F ∘ C_c)` with the unitary
2-D DFT evaluated as real matmul sandwiches
(`SenseDFT2RealOperator`). Complex-L1 regularization of the split vector
is exactly `L21Regularization(λ, slices=2)` — the group ℓ2 over (re, im)
pairs is the complex magnitude soft-threshold.
"""

import jax
import jax.numpy as jnp
import numpy as np

import rls_tpu as rt
from rls_tpu import solve

rng = np.random.default_rng(0)
H = W = 96
n = H * W
C = 6

# smooth complex coil sensitivities, sum-of-squares normalized to 1
yy, xx = np.mgrid[0:H, 0:W] / H
maps = np.stack(
    [
        (np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) * 2.0) + 0.15)
        * np.exp(1j * (cx * yy - cy * xx) * 2)
        for cy, cx in rng.uniform(0, 1, size=(C, 2))
    ]
).astype(np.complex64)
maps /= np.sqrt((np.abs(maps) ** 2).sum(0))

# 45% random k-space sampling + fully sampled calibration center
mask = (rng.uniform(size=(H, W)) < 0.45).astype(np.float32)
mask[H // 2 - 8:H // 2 + 8, W // 2 - 8:W // 2 + 8] = 1.0
op = rt.SenseDFT2RealOperator.from_maps(maps, mask, (H, W))

# complex phantom with spatial phase
img = np.zeros((H, W), np.complex64)
for _ in range(5):
    i0, j0 = rng.integers(4, H - 28, 2)
    img[i0:i0 + 20, j0:j0 + 20] += rng.uniform(0.4, 1.0) * np.exp(
        1j * rng.uniform(0, 1)
    )
x_true = jnp.concatenate(
    [jnp.asarray(img.real).reshape(-1), jnp.asarray(img.imag).reshape(-1)]
)
b = op.mv(x_true)

# FISTA with complex-L1 (L21 over re/im pairs)
solver = rt.FISTA.create(
    op, reg=rt.L21Regularization(1e-4, slices=2), iterations=80, rho=0.95
)
x = solve(solver, b)

rec = np.asarray(x)[:n] + 1j * np.asarray(x)[n:]
err = np.linalg.norm(rec.reshape(H, W) - img) / np.linalg.norm(img)
zf = np.asarray(op.rmv(b))
zf_err = np.linalg.norm((zf[:n] + 1j * zf[n:]).reshape(H, W) - img) / np.linalg.norm(img)
print(f"zero-filled rel err: {zf_err:.3f}")
print(f"FISTA complex-L1 rel err: {err:.3f}")
assert err < zf_err
