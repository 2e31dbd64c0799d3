"""Regularization framework: base types, decorator terms, λ-normalization.

JAX redesign of the reference's regularization layer
(/root/reference/src/Regularization/*.jl). Julia's multiple dispatch over a
decorator type hierarchy becomes plain pytree-dataclass composition: every
term is a frozen pytree with a pure functional ``prox(x, lam) -> x`` and
``value(x, lam) -> scalar``; decorators hold an inner term and transform the
call. λ values are traced leaves, so solvers can normalize/rescale them under
`jit` without recompilation.

Key mappings (reference file:line):
  * AbstractParameterizedRegularization / AbstractProjectionRegularization —
    Regularization/Regularization.jl:11,47
  * sink / findsink / findsinks — Regularization.jl:7-8,71-87
  * FixedScaled/FixedParameter/AutoScaled — ScaledRegularization.jl:26-78
  * NormalizedRegularization + strategies — NormalizedRegularization.jl
  * TransformedRegularization — TransformedRegularization.jl:20-33
  * MaskedRegularization — MaskedRegularization.jl:22-35
  * PlugAndPlayRegularization — PlugAndPlayRegularization.jl
  * input transforms — Transforms.jl
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from .._pytree import pytree_dataclass, static_field

__all__ = [
    "Regularization",
    "ParameterizedRegularization",
    "ProjectionRegularization",
    "NestedRegularization",
    "FixedScaledRegularization",
    "FixedParameterRegularization",
    "AutoScaledRegularization",
    "NormalizedRegularization",
    "TransformedRegularization",
    "MaskedRegularization",
    "PlugAndPlayRegularization",
    "PnPRegularization",
    "NoNormalization",
    "MeasurementBasedNormalization",
    "SystemMatrixBasedNormalization",
    "normalization_factor",
    "sink",
    "sink_type",
    "find_sink",
    "find_sinks",
    "reg_chain",
    "MinMaxTransform",
    "IdentityTransform",
    "ZTransform",
    "ClampedScalingTransform",
]


# --------------------------------------------------------------------------
# base types
# --------------------------------------------------------------------------


class Regularization:
    """Base for all regularization terms."""

    @property
    def inner(self) -> Optional["Regularization"]:
        return None

    def prox(self, x, lam=None):
        raise NotImplementedError

    def value(self, x, lam=None):
        """Value of the regularization functional (reference: ``norm``)."""
        raise NotImplementedError


class ParameterizedRegularization(Regularization):
    """Term with a regularization parameter λ (field name: ``lam``)."""

    lam: Any

    def get_lam(self):
        """Effective λ after decorator scaling (reference: ``λ(reg)``)."""
        return self.lam


class ProjectionRegularization(Regularization):
    """Indicator-function term: prox is a projection, no λ."""

    def get_lam(self):
        return None


def reg_chain(reg: Regularization):
    """Iterate the decorator chain from outermost to innermost
    (reference: Base.iterate on AbstractRegularization)."""
    while reg is not None:
        yield reg
        reg = reg.inner


def sink(reg: Regularization) -> Regularization:
    """Innermost term of a decorator chain (reference: ``sink``)."""
    last = reg
    for r in reg_chain(reg):
        last = r
    return last


def sink_type(reg: Regularization) -> type:
    return type(sink(reg))


def find_sink(cls, regs) -> Optional[int]:
    """Index of the unique term whose sink is of type `cls`
    (reference: ``findsink``, errors when ambiguous)."""
    hits = find_sinks(cls, regs)
    if not hits:
        return None
    if len(hits) > 1:
        raise ValueError(
            f"cannot unambiguously retrieve reg term of type {cls.__name__}, "
            f"found {len(hits)}"
        )
    return hits[0]


def find_sinks(cls, regs) -> list[int]:
    """Indices of all terms whose sink is an instance of `cls`
    (reference: ``findsinks``)."""
    return [i for i, r in enumerate(regs) if isinstance(sink(r), cls)]


# --------------------------------------------------------------------------
# nested / scaled decorators
# --------------------------------------------------------------------------


class NestedRegularization(Regularization):
    """Decorator base: delegates prox/value inward."""

    reg: Regularization

    @property
    def inner(self) -> Regularization:
        return self.reg

    def get_lam(self):
        return self.reg.get_lam()

    def prox(self, x, lam=None):
        if lam is None:
            lam = self.get_lam()
        return self.reg.prox(x, lam)

    def value(self, x, lam=None):
        if lam is None:
            lam = self.get_lam()
        return self.reg.value(x, lam)


@pytree_dataclass
class FixedScaledRegularization(NestedRegularization):
    """λ scaled by a fixed factor (reference ScaledRegularization.jl:26-33)."""

    reg: Regularization
    factor: Any

    def get_lam(self):
        return self.reg.get_lam() * self.factor


@pytree_dataclass
class FixedParameterRegularization(NestedRegularization):
    """Discards any incoming λ; always uses the inner term's own λ
    (reference ScaledRegularization.jl:41-50) — used to selectively
    disallow normalization."""

    reg: Regularization

    def prox(self, x, lam=None):
        return self.reg.prox(x, self.reg.get_lam())

    def value(self, x, lam=None):
        return self.reg.value(x, self.reg.get_lam())


@pytree_dataclass
class AutoScaledRegularization(NestedRegularization):
    """λ scaled by max|x| (reference ScaledRegularization.jl:53-78).

    Deviation from the reference: the reference latches the factor at the
    *first* prox call (mutable state). In this functional version the factor
    is recomputed from the current iterate at every call unless ``factor``
    is provided explicitly. For exact reference-parity trajectories use
    ``reg.latched(x_first)`` with the first prox input (the iterate after
    the first gradient step) — it pins ``factor = max|x_first|`` like the
    reference's one-time ``initFactor!``.
    """

    reg: Regularization
    factor: Optional[Any] = None

    def latched(self, x) -> "AutoScaledRegularization":
        """Copy with the reference's latched factor max|x| (see class doc)."""
        return AutoScaledRegularization(
            reg=self.reg, factor=jnp.max(jnp.abs(x))
        )

    def get_lam(self):
        if self.factor is None:
            return self.reg.get_lam()
        return self.reg.get_lam() * self.factor

    def _eff_lam(self, x, lam):
        if self.factor is not None:
            # latched: an explicit λ passes through unchanged (the caller
            # already fetched get_lam() · factor, like the reference's
            # post-latch branch); λ=None uses the factor-scaled accessor
            return self.get_lam() if lam is None else lam
        lam = self.reg.get_lam() if lam is None else lam
        return lam * jnp.max(jnp.abs(x))

    def prox(self, x, lam=None):
        return self.reg.prox(x, self._eff_lam(x, lam))

    def value(self, x, lam=None):
        return self.reg.value(x, self._eff_lam(x, lam))


@pytree_dataclass
class NormalizedRegularization(NestedRegularization):
    """λ scaled by a solver-computed normalization factor
    (reference NormalizedRegularization.jl:30-38)."""

    reg: Regularization
    factor: Any

    def get_lam(self):
        return self.reg.get_lam() * self.factor


# --------------------------------------------------------------------------
# normalization strategies
# --------------------------------------------------------------------------


class AbstractNormalization:
    pass


@pytree_dataclass
class NoNormalization(AbstractNormalization):
    pass


@pytree_dataclass
class MeasurementBasedNormalization(AbstractNormalization):
    pass


@pytree_dataclass
class SystemMatrixBasedNormalization(AbstractNormalization):
    pass


def normalization_factor(strategy, A, b):
    """λ scale factor for the given strategy (reference
    NormalizedRegularization.jl:40-58). Returns a traced scalar.

    * No: 1
    * MeasurementBased: ‖b‖₁ / length(b)
    * SystemMatrixBased: Σ_m ‖a_m‖² / N   (row energies of A)
    """
    if isinstance(strategy, NoNormalization) or strategy is None:
        return jnp.asarray(1.0, jnp.float32)
    if isinstance(strategy, MeasurementBasedNormalization):
        if b is None:
            return jnp.asarray(1.0, jnp.float32)
        b = jnp.asarray(b)
        return (jnp.sum(jnp.abs(b)) / b.size).real.astype(jnp.float32)
    if isinstance(strategy, SystemMatrixBasedNormalization):
        if A is None:
            raise ValueError(
                "SystemMatrixBasedNormalization requires supplying A to the solver"
            )
        return (jnp.sum(A.row_norms_sq()) / A.in_size).astype(jnp.float32)
    raise TypeError(f"unknown normalization strategy {strategy!r}")


# --------------------------------------------------------------------------
# transformed / masked decorators
# --------------------------------------------------------------------------


@pytree_dataclass
class TransformedRegularization(NestedRegularization):
    """prox in a transform domain: x ← Φᴴ prox(Φ x)
    (reference TransformedRegularization.jl:28-33)."""

    reg: Regularization
    trafo: Any  # LinearOperator

    def prox(self, x, lam=None):
        z = self.trafo.mv(x)
        z = self.reg.prox(z, lam) if lam is not None else self.reg.prox(z)
        return self.trafo.rmv(z)

    def value(self, x, lam=None):
        z = self.trafo.mv(x)
        return self.reg.value(z, lam) if lam is not None else self.reg.value(z)


@pytree_dataclass
class MaskedRegularization(NestedRegularization):
    """prox applied only to masked entries (reference
    MaskedRegularization.jl:31-35). The mask is static so the gathered
    subvector has a static shape under jit."""

    reg: Regularization
    mask: tuple = static_field()

    def __post_init__(self):
        object.__setattr__(self, "mask", tuple(bool(m) for m in self.mask))

    def _idx(self):
        return jnp.asarray([i for i, m in enumerate(self.mask) if m], jnp.int32)

    def prox(self, x, lam=None):
        idx = self._idx()
        z = x[idx]
        z = self.reg.prox(z, lam) if lam is not None else self.reg.prox(z)
        return x.at[idx].set(z)

    def value(self, x, lam=None):
        idx = self._idx()
        z = x[idx]
        return self.reg.value(z, lam) if lam is not None else self.reg.value(z)


# --------------------------------------------------------------------------
# input transforms for plug-and-play (reference Transforms.jl)
# --------------------------------------------------------------------------


class MinMaxTransform:
    def __init__(self, x):
        self.min = jnp.min(x)
        self.max = jnp.max(x)

    def forward(self, x):
        return (x - self.min) / (self.max - self.min)

    def backward(self, x):
        return x * (self.max - self.min) + self.min


class IdentityTransform:
    def __init__(self, x=None):
        pass

    def forward(self, x):
        return x

    def backward(self, x):
        return x


class ZTransform:
    def __init__(self, x):
        self.mean = jnp.mean(x)
        self.std = jnp.std(x)

    def forward(self, x):
        return (x - self.mean) / self.std

    def backward(self, x):
        return x * self.std + self.mean


class ClampedScalingTransform:
    def __init__(self, x, v_min, v_max):
        self.v_min = v_min
        self.v_max = v_max
        self.mask = (x < v_min) | (x >= v_max)
        self.x = x

    def forward(self, x):
        return (jnp.clip(x, self.v_min, self.v_max) - self.v_min) / (
            self.v_max - self.v_min
        )

    def backward(self, x):
        out = x * (self.v_max - self.v_min) + self.v_min
        return jnp.where(self.mask, self.x, out)


# --------------------------------------------------------------------------
# plug-and-play learned prox
# --------------------------------------------------------------------------


@pytree_dataclass
class PlugAndPlayRegularization(ParameterizedRegularization):
    """Learned denoiser as proximal map: x ← x − λ(x − model(x)), applied in
    a normalized input range (reference PlugAndPlayRegularization.jl).

    ``model`` is any callable array→array (e.g. a flax/haiku apply fn); it is
    static metadata, its parameters should be closed over. Complex inputs are
    denoised as two real problems (or only the real part if ``ignore_im``).
    """

    lam: Any
    model: Callable = static_field(default=None)
    shape: tuple = static_field(default=None)
    input_transform: Any = static_field(default=MinMaxTransform)
    ignore_im: bool = static_field(default=False)

    def __post_init__(self):
        if self.shape is not None:
            object.__setattr__(self, "shape", tuple(self.shape))
        # reference warns when λ is clipped to [0,1]
        # (PlugAndPlayRegularization.jl:47-51); the traced prox clamp below
        # cannot warn under jit, so mirror the warning eagerly for concrete λ
        lam = self.lam
        if not isinstance(lam, jax.core.Tracer):
            try:
                bad = bool((jnp.asarray(lam) < 0).any() | (jnp.asarray(lam) > 1).any())
            except (TypeError, jax.errors.TracerBoolConversionError):
                bad = False
            if bad:
                warnings.warn(
                    "PlugAndPlayRegularization λ is clipped to the [0, 1] "
                    "interval at prox time",
                    stacklevel=2,
                )

    def _prox_real(self, x, lam):
        lam = jnp.clip(lam, 0.0, 1.0)
        out = x.reshape(self.shape) if self.shape else x
        tf = self.input_transform(out)
        z = tf.forward(out)
        z = z - lam * (z - self.model(z))
        out = tf.backward(z)
        return out.reshape(x.shape)

    def prox(self, x, lam=None):
        if lam is None:
            lam = self.lam
        if jnp.issubdtype(x.dtype, jnp.complexfloating):
            re = self._prox_real(jnp.real(x), lam)
            if self.ignore_im:
                im = jnp.imag(x)
            else:
                im = self._prox_real(jnp.imag(x), lam)
            return (re + 1j * im).astype(x.dtype)
        return self._prox_real(x, lam)

    def value(self, x, lam=None):
        raise NotImplementedError(
            "PlugAndPlayRegularization has no explicit functional value"
        )


PnPRegularization = PlugAndPlayRegularization
