"""Split-real auto-routing for runtimes without complex dtypes.

Some accelerator runtimes hold no complex arrays. The reference treats
complex as first-class everywhere
(/root/reference/src/proximalMaps/ProxL1.jl:18-22), so instead of failing,
`create_linear_solver` transparently builds the *split-real twin* of a
complex problem on such runtimes (or when ``RLS_TPU_COMPLEX_OK=0`` forces
it):

    A_s = [[Re A, −Im A], [Im A, Re A]]       x_s = [Re x; Im x]
    b_s = [Re b; Im b]

and maps every regularization term onto the representation in which the
complex prox is EXACT on real planes:

    L2(λ)            → L2(λ)                 (‖x_s‖ = ‖x‖)
    L1(λ)            → L21(λ, slices=2)      (modulus soft threshold ==
                                              group threshold over
                                              (re_i, im_i) pairs)
    L21(λ, slices=s) → L21(λ, slices=2s)     (group norms pick up both
                                              planes of every entry)
    TV(λ, shape)     → TV(λ, shape, pair_planes=True)
                                              (FGP dual projection coupled
                                              across the plane pair — the
                                              exact complex-FGP recurrence)
    Real             → zero the imaginary half
    Positive         → zero the imaginary half + clamp the real half

Krylov and proximal-gradient trajectories on the twin coincide
step-for-step with the complex recurrences (all inner products involved
are real); row-action sweeps differ (one complex row becomes two real
rows) but converge to the same solution — the same guarantee the
reference's `solve!` gives across backends.

Entry points (`solve`, `solve_batched`, `solve_unrolled`,
`solve_batched_unrolled`, `solve_batched_fast`) recognize the
`SplitRealSolver` wrapper, embed `b` host-side (complex data never
touches the device), run the real twin, and reassemble a HOST numpy
complex64 result.
"""

from __future__ import annotations

import functools
import os
from typing import Any

import numpy as np

from .._pytree import pytree_dataclass, static_field

__all__ = [
    "backend_supports_complex",
    "SplitRealSolver",
    "build_split_real_solver",
    "embed_matrix",
    "embed_vec",
    "assemble_vec",
    "twin_regularization",
]


@functools.lru_cache(maxsize=1)
def backend_supports_complex() -> bool:
    """Whether the default backend can hold complex arrays: an allowlist
    of platforms with complex64 support, overridable with
    RLS_TPU_COMPLEX_OK=0/1 (0 forces the split-real route, which is how
    the CPU equivalence tests exercise it).
    """
    env = os.environ.get("RLS_TPU_COMPLEX_OK")
    if env is not None:
        return env not in ("0", "false", "False")
    import jax

    plat = jax.devices()[0].platform.lower()
    return plat in ("cpu", "gpu", "cuda", "rocm")


# --------------------------------------------------------------------------
# host-side embeddings (numpy only — nothing complex touches the device)
# --------------------------------------------------------------------------


def embed_matrix(A) -> np.ndarray:
    """Complex (m, n) → real f32 (2m, 2n) block matrix [[R, −I], [I, R]]."""
    A = np.asarray(A)
    top = np.hstack([A.real, -A.imag])
    bot = np.hstack([A.imag, A.real])
    return np.vstack([top, bot]).astype(np.float32)


def embed_vec(z) -> np.ndarray:
    """Complex (m,) or (m, K) → real f32 (2m,) / (2m, K) [re; im]."""
    z = np.asarray(z)
    return np.concatenate([z.real, z.imag], axis=0).astype(np.float32)


def assemble_vec(xs) -> np.ndarray:
    """Real (2n,) or (2n, K) [re; im] → host complex64."""
    xs = np.asarray(xs)
    n = xs.shape[0] // 2
    return (xs[:n] + 1j * xs[n:]).astype(np.complex64)


# --------------------------------------------------------------------------
# twin projections (complex Real/Positive semantics on [re; im])
# --------------------------------------------------------------------------


# defined lazily to avoid an import cycle (prox imports regularization)
def _make_twin_projections():
    import jax.numpy as jnp

    from .regularization import ProjectionRegularization

    @pytree_dataclass
    class TwinRealProjection(ProjectionRegularization):
        """enfReal! on the split pair: zero the imaginary half
        (reference Utils.jl enfReal!)."""

        n: int = static_field(default=0)

        def prox(self, x, lam=None):
            return x.at[self.n:].set(0.0)

        def value(self, x, lam=None):
            return jnp.asarray(0.0, jnp.float32)

    @pytree_dataclass
    class TwinPositiveProjection(ProjectionRegularization):
        """enfPos! on the split pair: clamp the real half, zero the
        imaginary half (reference Utils.jl enfPos!)."""

        n: int = static_field(default=0)

        def prox(self, x, lam=None):
            return jnp.concatenate(
                [jnp.maximum(x[: self.n], 0.0), jnp.zeros_like(x[self.n:])]
            )

        def value(self, x, lam=None):
            bad = jnp.any(x[: self.n] < 0) | jnp.any(x[self.n:] != 0)
            return jnp.where(bad, jnp.inf, 0.0).astype(jnp.float32)

    return TwinRealProjection, TwinPositiveProjection


@functools.lru_cache(maxsize=1)
def _twin_projection_classes():
    return _make_twin_projections()


def twin_regularization(reg, n: int):
    """Map one regularization term onto its split-real twin for a complex
    problem of size ``n`` (twin vector length 2n). Raises ValueError for
    terms with no exact twin yet."""
    from .prox import (
        L1Regularization,
        L2Regularization,
        L21Regularization,
        PositiveRegularization,
        RealRegularization,
        TVRegularization,
    )

    TwinReal, TwinPositive = _twin_projection_classes()

    if isinstance(reg, L2Regularization):
        return reg
    if isinstance(reg, L1Regularization):
        return L21Regularization(reg.lam, slices=2)
    if isinstance(reg, L21Regularization):
        return L21Regularization(reg.lam, slices=2 * reg.slices)
    if isinstance(reg, TVRegularization):
        if reg.pair_planes:
            raise ValueError("TV term is already a split-real pair twin")
        if isinstance(reg.dims, int):
            dims = (reg.dims,)
        else:
            dims = None if reg.dims is None else tuple(reg.dims)
        return TVRegularization(
            reg.lam,
            shape=reg.shape,
            dims=dims,
            iterations_tv=reg.iterations_tv,
            unroll=reg.unroll,
            pair_planes=True,
        )
    if isinstance(reg, RealRegularization):
        return TwinReal(n=n)
    if isinstance(reg, PositiveRegularization):
        return TwinPositive(n=n)
    raise ValueError(
        f"no split-real twin for {type(reg).__name__}; build the real "
        "embedding by hand or run on a complex-capable backend"
    )


# --------------------------------------------------------------------------
# the wrapper
# --------------------------------------------------------------------------


@pytree_dataclass
class SplitRealSolver:
    """A complex solver auto-lowered to its split-real twin.

    ``inner`` is a real LinearSolver over the (2m, 2n) embedding; ``n``
    the complex solution length. The solve entry points in
    `models/solvers/base.py` recognize this wrapper: they embed b
    host-side, run the twin on device, and return HOST numpy complex64
    (the device cannot hold complex arrays)."""

    inner: Any
    n: int = static_field(default=0)

    @property
    def iterations(self):
        return self.inner.iterations

    def embed_b(self, b):
        return embed_vec(b)

    def assemble(self, xs):
        return assemble_vec(np.asarray(xs))


def build_split_real_solver(
    solver_cls, A, reg=None, normalize_reg=None, **kwargs
) -> SplitRealSolver:
    """Construct the split-real twin solver for complex system matrix
    ``A`` (host numpy/jax array or DenseOperator). The twin is created
    through ``solver_cls.create`` so every solver-specific precompute
    (row norms, power-iteration step size, CG closures) runs on the real
    embedding."""
    from ..ops.base import DenseOperator, LinearOperator
    from .regularization import NoNormalization

    if isinstance(A, LinearOperator):
        if not isinstance(A, DenseOperator):
            raise ValueError(
                "split-real auto-routing handles dense complex matrices; "
                f"operator {type(A).__name__} needs a native split-real "
                "operator (see ops/dft_real.py for the DFT/SENSE family)"
            )
        A = A.mat
    Anp = np.asarray(A)
    if not np.iscomplexobj(Anp):
        raise ValueError("A is real; no split-real routing needed")
    n = Anp.shape[1]
    if normalize_reg is not None and not isinstance(
        normalize_reg, NoNormalization
    ):
        raise ValueError(
            "split-real auto-routing supports NoNormalization only: the "
            "measurement/system normalization factors are defined on the "
            "complex data (‖b‖₁/len differs on split planes); compute the "
            "factor host-side and fold it into λ"
        )
    regs = reg if isinstance(reg, (list, tuple)) else (
        [] if reg is None else [reg])
    twins = [twin_regularization(r, n) for r in regs]
    if not isinstance(reg, (list, tuple)):
        twins = twins[0] if twins else None
    import jax.numpy as jnp

    from ..ops.base import DenseOperator as _Dense

    # compensated matvecs: hold f32 accuracy even where the runtime rounds
    # matmul inputs below f32
    As = _Dense(jnp.asarray(embed_matrix(Anp)), compensated=True)
    inner = solver_cls.create(As, reg=twins, **kwargs)
    return SplitRealSolver(inner=inner, n=n)
