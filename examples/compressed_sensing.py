"""Compressed sensing — sparse image recovery from subsampled Fourier
measurements (reference docs/src/literate/examples/compressed_sensing.jl).

The operator is matrix-free: `SubsampledFFTOperator` fuses AᴴA into
FFT → mask → IFFT, the FISTA-TV hot loop is one jitted program.
"""

import jax
import jax.numpy as jnp
import numpy as np

import rls_tpu as rt

rng = np.random.default_rng(0)
N = 64

# piecewise-constant phantom
img = np.zeros((N, N), np.float32)
img[16:48, 16:48] = 1.0
img[24:40, 24:40] = 2.0
x_true = jnp.asarray(img.reshape(-1), jnp.complex64)

# random 40% Fourier sampling
n2 = N * N
idx = np.sort(rng.choice(n2, size=int(0.4 * n2), replace=False))
idx[0] = 0
op = rt.SubsampledFFTOperator(sample_idx=jnp.asarray(idx, jnp.int32), im_shape=(N, N))
b = op.mv(x_true)

# zero-filled reconstruction (baseline)
x_zf = op.rmv(b)
print("zero-filled rel. error:",
      float(jnp.linalg.norm(x_zf - x_true) / jnp.linalg.norm(x_true)))

# FISTA with TV prior
solver = rt.FISTA.create(
    op,
    reg=rt.TVRegularization(1e-2, shape=(N, N), iterations_tv=20),
    iterations=50,
    rho=0.95,  # ‖AᴴA‖ = 1 for a subsampled unitary FFT
)
x = jax.jit(rt.solve)(solver, b)
print("FISTA-TV rel. error:",
      float(jnp.linalg.norm(x - x_true) / jnp.linalg.norm(x_true)))

# FISTA with an L1-wavelet sparsity prior (the docs' WaveletOp workflow:
# reference explanations/regularization.jl nests L1 around the transform).
# Wavelet atoms are coherent with uniform-random Fourier masks at coarse
# scales, so CS practice samples with VARIABLE DENSITY — dense at low
# frequencies, sparse at high:
ky, kx = np.meshgrid(np.fft.fftfreq(N), np.fft.fftfreq(N), indexing="ij")
rad = np.sqrt(ky**2 + kx**2).reshape(-1)
pdf = 1.0 / (1.0 + (rad / 0.08) ** 2)
pdf /= pdf.sum()
idx_vd = np.sort(rng.choice(n2, size=int(0.4 * n2), replace=False, p=pdf))
idx_vd[0] = 0
op_vd = rt.SubsampledFFTOperator(
    sample_idx=jnp.asarray(idx_vd, jnp.int32), im_shape=(N, N)
)
b_vd = op_vd.mv(x_true)

wop = rt.WaveletOperator((N, N), wavelet="haar", _dtype=jnp.complex64)
solver = rt.FISTA.create(
    op_vd,
    reg=rt.TransformedRegularization(rt.L1Regularization(3e-3), wop),
    iterations=150,
    rho=0.95,
)
x_w = jax.jit(rt.solve)(solver, b_vd)
err_w = float(jnp.linalg.norm(x_w - x_true) / jnp.linalg.norm(x_true))
print("FISTA-L1-wavelet (variable-density mask) rel. error:", err_w)
assert err_w < 0.01

# --- dense sensing matrices: batched fixed-iteration FISTA -------------
rngd = np.random.default_rng(7)
md, nd = 128, 256
Ad = jnp.asarray(rngd.normal(size=(md, nd)) / np.sqrt(md), jnp.float32)
xd = jnp.asarray(
    rngd.normal(size=(nd,)) * (rngd.uniform(size=(nd,)) < 0.05), jnp.float32
)
Bd = (Ad @ xd)[:, None]
Ld = float(np.linalg.norm(np.asarray(Ad), 2) ** 2)
# note restart: the reference's raw-gradient restart rule stalls on LASSO
# (fires ~80% of iterations); use "gradient_mapping" (the composite
# O'Donoghue-Candes test) or leave restart off — docs/API_PARITY.md #5
sd = rt.FISTA.create(
    rt.DenseOperator(Ad), reg=rt.L1Regularization(1e-4), iterations=1000,
    rho=0.95 / Ld, restart="gradient_mapping", track_residual=False,
)
Xd = rt.solve_batched_fast(sd, Bd)
err_d = float(jnp.linalg.norm(Xd[:, 0] - xd) / jnp.linalg.norm(xd))
print(f"dense CS (batched FISTA): rel_err={err_d:.2e}")
