"""Proximal-map library.

JAX re-implementations of the reference's proximal operators
(/root/reference/src/proximalMaps/*.jl). All proxes are pure functions on
flat arrays; elementwise ones fuse into the surrounding solver step under
XLA, the TV prox is a fused dual FGP loop, and nuclear/LLR use batched
`jnp.linalg.svd` (maps to batched small-matrix factorizations).

Mapping (reference file → class):
  ProxL1.jl       → L1Regularization       (complex-safe soft threshold)
  ProxL2.jl       → L2Regularization       (scalar or vector λ / Tikhonov)
  ProxL21.jl      → L21Regularization      (group soft threshold)
  ProxTV.jl       → TVRegularization       (FGP dual loop; 1-D exact Condat)
  ProxTVCondat.jl → tv_condat.py
  ProxNuclear.jl  → NuclearRegularization  (SVT)
  ProxLLR.jl      → LLRRegularization      (blockwise batched SVT)
  ProxPositive.jl → PositiveRegularization
  ProxReal.jl     → RealRegularization
  ProxProj.jl     → ProjectionRegularizationTerm
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .._pytree import pytree_dataclass, static_field
from ..ops.grad import GradientOperator
from ..utils.misc import enf_pos, enf_real
from .regularization import ParameterizedRegularization, ProjectionRegularization
from .tv_condat import prox_tv_1d_axis

__all__ = [
    "L1Regularization",
    "L2Regularization",
    "L21Regularization",
    "TVRegularization",
    "NuclearRegularization",
    "LLRRegularization",
    "PositiveRegularization",
    "RealRegularization",
    "ProjectionRegularizationTerm",
    "soft_threshold",
    "prox_tv_fgp",
]


def _real_dtype(dtype):
    return jnp.zeros((), dtype).real.dtype


def soft_threshold(x, lam):
    """Complex-safe soft threshold (reference ProxL1.jl:18-22):
    ``max(|x|−λ, 0) · (x+ε)/(|x|+ε)``."""
    eps = jnp.finfo(_real_dtype(x.dtype)).eps
    mag = jnp.abs(x)
    return jnp.maximum(mag - lam, 0) * (x + eps) / (mag + eps)


# --------------------------------------------------------------------------


@pytree_dataclass
class L1Regularization(ParameterizedRegularization):
    lam: Any

    def prox(self, x, lam=None):
        lam = self.lam if lam is None else lam
        return soft_threshold(x, lam)

    def value(self, x, lam=None):
        lam = self.lam if lam is None else lam
        return lam * jnp.sum(jnp.abs(x))


@pytree_dataclass
class L2Regularization(ParameterizedRegularization):
    """Tikhonov term ½·2λ‖x‖²; λ may be a vector (diagonal Tikhonov matrix,
    reference ProxL2.jl + Kaczmarz.jl:378-391)."""

    lam: Any

    def prox(self, x, lam=None):
        lam = self.lam if lam is None else lam
        return x / (1.0 + 2.0 * lam)

    def value(self, x, lam=None):
        lam = self.lam if lam is None else lam
        lam = jnp.asarray(lam)
        if lam.ndim > 0:
            return jnp.sum(lam * jnp.abs(x) ** 2)
        return lam * jnp.sum(jnp.abs(x) ** 2)


@pytree_dataclass
class L21Regularization(ParameterizedRegularization):
    """Group soft threshold (reference ProxL21.jl). The vector is viewed as
    `slices` stacked groups of length ``len/x slices``; group g collects
    x[g::sliceLength] — i.e. reshape to (slices, sliceLength) and take norms
    over axis 0."""

    lam: Any
    slices: int = static_field(default=1)

    def _group_scale(self, x, lam):
        sl = x.shape[0] // self.slices
        x2 = x.reshape(self.slices, sl)
        gn = jnp.sqrt(jnp.sum(jnp.abs(x2) ** 2, axis=0))
        scale = jnp.maximum((gn - lam) / jnp.where(gn == 0, 1.0, gn), 0)
        return x2, gn, scale

    def prox(self, x, lam=None):
        lam = self.lam if lam is None else lam
        x2, _, scale = self._group_scale(x, lam)
        return (x2 * scale[None, :]).reshape(-1)

    def value(self, x, lam=None):
        lam = self.lam if lam is None else lam
        _, gn, _ = self._group_scale(x, lam)
        return lam * jnp.sum(gn)


# --------------------------------------------------------------------------
# TV
# --------------------------------------------------------------------------


def prox_tv_fgp(x, lam, grad_op: GradientOperator, iterations: int, unroll=False):
    """Fast Gradient Projection on the TV dual (Beck & Teboulle 2009),
    mirroring the reference's FGP loop (ProxTV.jl:89-125). The whole loop is
    jit-fused: each iteration is gradient-op matvecs + elementwise clamping +
    momentum, which XLA fuses into a short kernel sequence."""
    rdt = _real_dtype(x.dtype)
    lam = jnp.asarray(lam, rdt)
    lam_safe = jnp.where(lam > 0, lam, 1.0)
    G = grad_op

    pq0 = jnp.zeros((G.out_size,), x.dtype)

    def body(_, carry):
        pq_old, rs, t = carry
        xtmp = x - lam * G.rmv(rs)
        pq = rs + G.mv(xtmp) / (8.0 * lam_safe)
        pq = pq / jnp.maximum(1.0, jnp.abs(pq))
        t_new = (1.0 + jnp.sqrt(1.0 + 4.0 * t * t)) / 2.0
        t2 = (t - 1.0) / t_new
        rs_new = (1.0 + t2) * pq - t2 * pq_old
        return (pq, rs_new, t_new)

    carry = (pq0, pq0, jnp.asarray(1.0, rdt))
    if unroll:
        # python-unrolled loop: one straight-line fused XLA program with
        # no control-flow primitives
        for i in range(iterations):
            carry = body(i, carry)
        pq = carry[0]
    else:
        pq, _, _ = lax.fori_loop(0, iterations, body, carry)
    return x - lam * G.rmv(pq)


def prox_tv_fgp_pair(x2, lam, grad_op: GradientOperator, iterations: int,
                     unroll=False):
    """FGP TV prox on a (2, n) REAL plane pair [re; im] with the dual
    projection coupled across planes — the exact split-real twin of the
    complex FGP: every recurrence is linear except the projection, whose
    complex modulus |p| becomes √(p_re² + p_im²). Trajectories coincide
    step-for-step with `prox_tv_fgp` on the complex array."""
    rdt = _real_dtype(x2.dtype)
    lam = jnp.asarray(lam, rdt)
    lam_safe = jnp.where(lam > 0, lam, 1.0)
    G = grad_op
    vmv = jax.vmap(G.mv)
    vrmv = jax.vmap(G.rmv)

    pq0 = jnp.zeros((2, G.out_size), x2.dtype)

    def body(_, carry):
        pq_old, rs, t = carry
        xtmp = x2 - lam * vrmv(rs)
        pq = rs + vmv(xtmp) / (8.0 * lam_safe)
        mod = jnp.sqrt(jnp.sum(pq * pq, axis=0, keepdims=True))
        pq = pq / jnp.maximum(1.0, mod)
        t_new = (1.0 + jnp.sqrt(1.0 + 4.0 * t * t)) / 2.0
        t2 = (t - 1.0) / t_new
        rs_new = (1.0 + t2) * pq - t2 * pq_old
        return (pq, rs_new, t_new)

    carry = (pq0, pq0, jnp.asarray(1.0, rdt))
    if unroll:
        for i in range(iterations):
            carry = body(i, carry)
        pq = carry[0]
    else:
        pq, _, _ = lax.fori_loop(0, iterations, body, carry)
    return x2 - lam * vrmv(pq)


@pytree_dataclass
class TVRegularization(ParameterizedRegularization):
    """TV prox: exact 1-D Condat when `dims` is a single int (reference
    ProxTV.jl:64-79), FGP dual iteration otherwise (:89-125).

    `dims` uses 0-based axes (the reference is 1-based Julia).

    ``pair_planes=True`` treats the input as TWO stacked real planes
    [re; im] of a complex image and couples the FGP dual projection
    across them — the exact split-real twin of the complex TV prox for
    runtimes without complex dtypes (models/split_real.py)."""

    lam: Any
    shape: tuple = static_field(default=None)
    dims: Any = static_field(default=None)
    iterations_tv: int = static_field(default=10)
    unroll: bool = static_field(default=False)
    pair_planes: bool = static_field(default=False)

    def __post_init__(self):
        if self.shape is not None:
            object.__setattr__(self, "shape", tuple(self.shape))
        if self.dims is None and self.shape is not None:
            object.__setattr__(self, "dims", tuple(range(len(self.shape))))

    def _grad_op(self, dtype):
        dims = self.dims if not isinstance(self.dims, int) else (self.dims,)
        return GradientOperator(im_shape=self.shape, dims=tuple(dims), _dtype=dtype)

    def prox(self, x, lam=None):
        lam = self.lam if lam is None else lam
        is_complex = jnp.issubdtype(x.dtype, jnp.complexfloating)
        if self.pair_planes:
            n = math.prod(self.shape)
            out = prox_tv_fgp_pair(
                x.reshape(2, n), lam, self._grad_op(x.dtype),
                self.iterations_tv, self.unroll,
            )
            return out.reshape(x.shape)
        if isinstance(self.dims, int) and not is_complex:
            img = x.reshape(self.shape)
            return prox_tv_1d_axis(img, lam, self.dims).reshape(x.shape)
        return prox_tv_fgp(
            x, lam, self._grad_op(x.dtype), self.iterations_tv, self.unroll
        )

    def value(self, x, lam=None):
        lam = self.lam if lam is None else lam
        if self.pair_planes:
            n = math.prod(self.shape)
            g = jax.vmap(self._grad_op(x.dtype).mv)(x.reshape(2, n))
            return lam * jnp.sum(jnp.sqrt(jnp.sum(g * g, axis=0)))
        g = self._grad_op(x.dtype).mv(x.reshape(-1))
        return lam * jnp.sum(jnp.abs(g))


# --------------------------------------------------------------------------
# nuclear & locally-low-rank
# --------------------------------------------------------------------------


def _use_jacobi(m, method: str) -> bool:
    """Jacobi SVT applies to REAL F32 input (the compensated final matmul
    bit-splits f32; f64 runs XLA's SVD); "auto" additionally caps the
    minor dimension at 128, because the sweep loop is unrolled n−1 steps
    per sweep and compile time grows with min(m, n). Whether this gate
    still pays against cuSOLVER's batched SVD is not measured."""
    if m.dtype != jnp.float32:
        return False
    if method == "jacobi":
        return True
    return method == "auto" and min(m.shape[-2:]) <= 128


def _svt(m, lam, method: str = "auto"):
    """Batched singular-value soft threshold dispatch: the one-sided
    Jacobi path (ops/jacobi_svd.py) wherever `_use_jacobi` applies (real
    f32, small minor dim), XLA's SVD otherwise.
    """
    if _use_jacobi(m, method):
        from ..ops.jacobi_svd import svt_jacobi

        if m.shape[-2] < m.shape[-1]:  # SVT(Aᵀ) = SVT(A)ᵀ; keep n small
            return jnp.swapaxes(
                svt_jacobi(jnp.swapaxes(m, -1, -2), lam), -1, -2
            )
        return svt_jacobi(m, lam)
    u, s, vh = jnp.linalg.svd(m, full_matrices=False)
    s = jnp.maximum(s - lam, 0).astype(s.dtype)
    return (u * s[..., None, :].astype(u.dtype)) @ vh


def _svdvals(m, method: str = "auto"):
    if _use_jacobi(m, method):
        from ..ops.jacobi_svd import jacobi_svdvals

        if m.shape[-2] < m.shape[-1]:  # match svd's min(m, n) count
            m = jnp.swapaxes(m, -1, -2)
        return jacobi_svdvals(m)
    return jnp.linalg.svd(m, compute_uv=False)


@pytree_dataclass
class NuclearRegularization(ParameterizedRegularization):
    """Singular value soft-thresholding (reference ProxNuclear.jl).

    `svd_method`: "auto" (Jacobi SVT for real input with small minor dim,
    XLA SVD otherwise), "jacobi", or "xla".
    """

    lam: Any
    svt_shape: tuple = static_field(default=None)
    svd_method: str = static_field(default="auto")

    def __post_init__(self):
        if self.svt_shape is not None:
            object.__setattr__(self, "svt_shape", tuple(self.svt_shape))

    def prox(self, x, lam=None):
        lam = self.lam if lam is None else lam
        m = x.reshape(self.svt_shape)
        return _svt(m, lam, self.svd_method).reshape(x.shape)

    def value(self, x, lam=None):
        lam = self.lam if lam is None else lam
        s = _svdvals(x.reshape(self.svt_shape), self.svd_method)
        return lam * jnp.sum(s)


def _block_partition(img, block):
    """(s0..sn, K) zero-padded → (L, prod(block), K) distinct blocks."""
    shape = img.shape[:-1]
    K = img.shape[-1]
    nd = len(shape)
    pads = [(0, (-shape[d]) % block[d]) for d in range(nd)] + [(0, 0)]
    xp = jnp.pad(img, pads)
    pshape = xp.shape[:-1]
    # interleave: (n0, b0, n1, b1, ..., K)
    inter = []
    for d in range(nd):
        inter += [pshape[d] // block[d], block[d]]
    xr = xp.reshape(*inter, K)
    # → (n0, n1, ..., b0, b1, ..., K)
    perm = [2 * d for d in range(nd)] + [2 * d + 1 for d in range(nd)] + [2 * nd]
    xt = xr.transpose(perm)
    L = math.prod(pshape[d] // block[d] for d in range(nd))
    return xt.reshape(L, math.prod(block), K), pshape


def _block_departition(blocks, block, pshape, orig_shape, K):
    nd = len(orig_shape)
    nblk = [pshape[d] // block[d] for d in range(nd)]
    xt = blocks.reshape(*nblk, *block, K)
    perm = []
    for d in range(nd):
        perm += [d, nd + d]
    perm += [2 * nd]
    xr = xt.transpose(perm).reshape(*pshape, K)
    sl = tuple(slice(0, s) for s in orig_shape) + (slice(0, K),)
    return xr[sl]


@pytree_dataclass
class LLRRegularization(ParameterizedRegularization):
    """Locally-low-rank prox: blockwise SVT over image patches with optional
    random block shift and fully-overlapping mode (reference ProxLLR.jl).

    All patches are gathered into one (L, prod(block), K) tensor
    and thresholded with a single *batched* SVD — the reference's per-patch
    threaded loop becomes one batched kernel. The Ong/Lustig skip test
    (ProxLLR.jl:72-74) is subsumed: SVT itself zeroes blocks whose singular
    values are all ≤ λ.

    Deviation: `randshift` derives the shift from a fixed seed (pure
    function), not a global RNG.
    """

    lam: Any
    shape: tuple = static_field(default=None)
    block_size: tuple = static_field(default=None)
    randshift: bool = static_field(default=True)
    fully_overlapping: bool = static_field(default=False)
    L: int = static_field(default=1)
    seed: int = static_field(default=1234)
    svd_method: str = static_field(default="auto")  # see NuclearRegularization

    def __post_init__(self):
        if self.shape is not None:
            object.__setattr__(self, "shape", tuple(self.shape))
        bs = self.block_size
        if bs is None and self.shape is not None:
            bs = tuple(2 for _ in self.shape)
        if bs is not None:
            object.__setattr__(self, "block_size", tuple(bs))

    # -- single non-overlapping pass ------------------------------------
    def _svt_blocks(self, img, lam):
        blocks, pshape = _block_partition(img, self.block_size)
        recon = _svt(blocks, lam, self.svd_method)
        K = img.shape[-1]
        return _block_departition(recon, self.block_size, pshape, img.shape[:-1], K)

    def _prox_nonoverlapping(self, img, lam):
        if self.randshift:
            key = jax.random.PRNGKey(self.seed)
            # shifts stay TRACED (jnp.roll accepts dynamic shifts) so the
            # prox is jittable; int() here would raise under jit
            shifts = [
                jax.random.randint(jax.random.fold_in(key, d), (), 0, b)
                for d, b in enumerate(self.block_size)
            ]
            shifted = jnp.roll(img, shifts, axis=tuple(range(len(self.shape))))
            out = self._svt_blocks(shifted, lam)
            return jnp.roll(
                out, [-s for s in shifts], axis=tuple(range(len(self.shape)))
            )
        return self._svt_blocks(img, lam)

    def _prox_overlapping(self, img, lam):
        """Average of all block-shifted non-overlapping passes
        (reference proxLLROverlapping!, ProxLLR.jl:160-195)."""
        nd = len(self.shape)
        axes = tuple(range(nd))
        total = jnp.zeros_like(img)
        count = math.prod(self.block_size)
        import itertools

        for shift in itertools.product(*(range(b) for b in self.block_size)):
            xs = jnp.roll(img, shift, axis=axes)
            ys = self._svt_blocks(xs, lam)
            total = total + jnp.roll(ys, [-s for s in shift], axis=axes)
        return total / count

    def prox(self, x, lam=None):
        lam = self.lam if lam is None else lam
        nvox = math.prod(self.shape)
        K = x.size // nvox
        img = x.reshape(*self.shape, K)
        if self.fully_overlapping:
            out = self._prox_overlapping(img, lam)
        else:
            out = self._prox_nonoverlapping(img, lam)
        return out.reshape(x.shape)

    def value(self, x, lam=None):
        """Σλ‖block‖_* over *full* blocks only: the reference's
        blockNuclearNorm (ProxLLR.jl:115-152) circshifts by the seeded
        randshift, then counts L = floor(prod(shape)/prod(block)) blocks
        — trailing partial blocks of non-dividing shapes never enter the
        norm. We zero-pad for a rectangular batched SVD (zero rows leave
        singular values unchanged) and mask the partial blocks out of
        the sum. The shift uses the same pure seed derivation as prox
        (documented deviation from Julia's global srand(1234))."""
        lam = self.lam if lam is None else lam
        nvox = math.prod(self.shape)
        K = x.size // (nvox * self.L)
        nd = len(self.shape)
        # mask over block indices: 1 where the block lies fully inside
        # the original shape (i.e. not a zero-padded trailing block)
        nblk = [-(-self.shape[d] // self.block_size[d]) for d in range(nd)]
        full = np.zeros(nblk, np.float32)
        full[tuple(slice(0, self.shape[d] // self.block_size[d])
                   for d in range(nd))] = 1.0
        full = jnp.asarray(full.reshape(-1))
        total = 0.0
        for i in range(self.L):
            chunk = x[i * nvox * K : (i + 1) * nvox * K].reshape(*self.shape, K)
            if self.randshift:
                key = jax.random.PRNGKey(self.seed)
                shifts = [
                    jax.random.randint(jax.random.fold_in(key, d), (), 0, b)
                    for d, b in enumerate(self.block_size)
                ]
                chunk = jnp.roll(chunk, shifts, axis=tuple(range(nd)))
            blocks, _ = _block_partition(chunk, self.block_size)
            s = _svdvals(blocks, self.svd_method)
            total = total + jnp.sum(full[:, None] * s)
        return lam * total


# --------------------------------------------------------------------------
# projections
# --------------------------------------------------------------------------


@pytree_dataclass
class PositiveRegularization(ProjectionRegularization):
    def prox(self, x, lam=None):
        return enf_pos(enf_real(x))

    def value(self, x, lam=None):
        ok = jnp.all(self.prox(x) == x)
        return jnp.where(ok, 0.0, jnp.inf)


@pytree_dataclass
class RealRegularization(ProjectionRegularization):
    def prox(self, x, lam=None):
        return enf_real(x)

    def value(self, x, lam=None):
        ok = jnp.all(self.prox(x) == x)
        return jnp.where(ok, 0.0, jnp.inf)


@pytree_dataclass
class ProjectionRegularizationTerm(ProjectionRegularization):
    """Arbitrary user projection (reference ProxProj.jl)."""

    proj_func: Callable = static_field(default=None)

    def prox(self, x, lam=None):
        return self.proj_func(x)

    def value(self, x, lam=None):
        ok = jnp.all(self.prox(x) == x)
        return jnp.where(ok, 0.0, jnp.inf)
