"""Solver registry, applicability rules, and the `create_linear_solver`
factory with kwarg filtering.

Behavioral port of /root/reference/src/RegularizedLeastSquares.jl:210-294:
  * `linear_solver_list` — reflection-based list (:213-220)
  * `is_applicable` — category rules (:223-256)
  * `applicable_solver_list` (:265)
  * `create_linear_solver` + `filter_kwargs` with a warning for dropped
    keys (:267-294)
"""

from __future__ import annotations

import inspect
import warnings
from typing import Sequence, Type, Union

import jax.numpy as jnp
import numpy as np

from .models.prox import L2Regularization
from .models.regularization import (
    ParameterizedRegularization,
    Regularization,
    find_sinks,
)
from .models.solvers import (
    ADMM,
    CGNR,
    FISTA,
    PDHG,
    POGM,
    DaxConstrained,
    DaxKaczmarz,
    DirectSolver,
    Kaczmarz,
    LinearSolver,
    OptISTA,
    PseudoInverse,
    SplitBregman,
)

__all__ = [
    "linear_solver_list",
    "solver_by_name",
    "is_applicable",
    "applicable_solver_list",
    "create_linear_solver",
    "filter_kwargs",
    "ROW_ACTION_SOLVERS",
    "PROXIMAL_GRADIENT_SOLVERS",
    "PRIMAL_DUAL_SOLVERS",
    "KRYLOV_SOLVERS",
    "DIRECT_SOLVERS",
]

# solver taxonomy (reference abstract subtypes, RegularizedLeastSquares.jl:135-148)
ROW_ACTION_SOLVERS = (Kaczmarz,)
DAX_SOLVERS = (DaxKaczmarz, DaxConstrained)  # disabled upstream; opt-in here
KRYLOV_SOLVERS = (CGNR,)
PROXIMAL_GRADIENT_SOLVERS = (FISTA, OptISTA, POGM)
PRIMAL_DUAL_SOLVERS = (ADMM, SplitBregman, PDHG)
DIRECT_SOLVERS = (DirectSolver, PseudoInverse)

_ALL = (
    ROW_ACTION_SOLVERS
    + KRYLOV_SOLVERS
    + PROXIMAL_GRADIENT_SOLVERS
    + PRIMAL_DUAL_SOLVERS
    + DIRECT_SOLVERS
)

# like the reference's linearSolverListReal vs linearSolverList split
# (RegularizedLeastSquares.jl:213-220): Dax solvers are constructible by
# name but not part of the default solver list.
_EXTRA = DAX_SOLVERS


def linear_solver_list() -> list[Type[LinearSolver]]:
    """All available solvers (reference linearSolverList)."""
    return list(_ALL)


def linear_solver_list_real() -> list[Type[LinearSolver]]:
    """Reflection-style full solver list, including the upstream-disabled
    row-action/primal-dual extras (reference linearSolverListReal — the
    unfiltered `subtypes` union, RegularizedLeastSquares.jl:218-220)."""
    return list(_ALL) + list(_EXTRA)


def deinit(solver: LinearSolver) -> None:
    """Reference API shim (`deinit`): frees per-solve buffers there. Our
    states are immutable pytrees owned by the caller, so there is nothing
    to release — provided for call-site compatibility."""
    return None


def solver_by_name(name: str) -> Type[LinearSolver]:
    for cls in _ALL + _EXTRA:
        if cls.__name__.lower() == name.lower():
            return cls
    raise KeyError(f"unknown solver {name!r}; available: "
                   f"{[c.__name__ for c in _ALL + _EXTRA]}")


def _as_reg_list(reg) -> list[Regularization]:
    if isinstance(reg, Regularization):
        return [reg]
    return list(reg)


def is_applicable(solver_type, reg) -> bool:
    """Category applicability rules
    (reference RegularizedLeastSquares.jl:223-256)."""
    if isinstance(solver_type, LinearSolver):
        solver_type = type(solver_type)
    regs = _as_reg_list(reg)
    if solver_type in ROW_ACTION_SOLVERS:
        n_param = len(find_sinks(ParameterizedRegularization, regs))
        n_l2 = len(find_sinks(L2Regularization, regs))
        return n_param <= 2 and n_l2 == 1
    if solver_type in PROXIMAL_GRADIENT_SOLVERS:
        return len(find_sinks(ParameterizedRegularization, regs)) == 1
    if solver_type in PRIMAL_DUAL_SOLVERS:
        return True
    if solver_type in KRYLOV_SOLVERS or solver_type in DIRECT_SOLVERS:
        # only an L2 sink (plus projections) is supported
        n_param = len(find_sinks(ParameterizedRegularization, regs))
        n_l2 = len(find_sinks(L2Regularization, regs))
        return n_param == n_l2 and n_l2 <= 1
    return False


def applicable_solver_list(reg) -> list[Type[LinearSolver]]:
    return [s for s in _ALL if is_applicable(s, reg)]


def filter_kwargs(solver_type: Type[LinearSolver], kwargs, kwarg_warning=True):
    """Keep only kwargs accepted by `solver_type.create`; warn about the
    rest (reference filterKwargs, RegularizedLeastSquares.jl:267-278)."""
    sig = inspect.signature(solver_type.create)
    accepts_var_kw = any(
        p.kind == inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()
    )
    keys = set(sig.parameters) - {"cls", "A", "kwargs", "_"}
    kept = {k: v for k, v in kwargs.items() if k in keys}
    dropped = [k for k in kwargs if k not in keys]
    if dropped and kwarg_warning:
        warnings.warn(
            f"The following arguments were passed but filtered out: "
            f"{', '.join(dropped)}. Please watch closely if this introduces "
            f"unexpected behaviour in your code."
        )
    return kept


def create_linear_solver(
    solver: Union[str, Type[LinearSolver]],
    A=None,
    *,
    AHA=None,
    kwarg_warning: bool = True,
    **kwargs,
) -> LinearSolver:
    """Factory (reference createLinearSolver, :288-294). `solver` may be a
    class or its name (case-insensitive).

    On runtimes without complex dtypes, a complex
    dense ``A`` transparently builds the split-real twin solver — the
    solve entry points embed b / reassemble x host-side and return numpy
    complex64 (models/split_real.py). Complex is first-class in the
    reference everywhere, so failing here would be a capability gap, not
    a semantics choice."""
    if isinstance(solver, str):
        solver = solver_by_name(solver)
    kept = filter_kwargs(solver, kwargs, kwarg_warning)
    if AHA is not None:
        kept["AHA"] = AHA
    if A is not None and AHA is None:
        from .models.split_real import backend_supports_complex
        from .ops.base import DenseOperator, LinearOperator

        host_complex = not isinstance(A, LinearOperator) and np.iscomplexobj(A)
        dense_complex = isinstance(A, DenseOperator) and jnp.issubdtype(
            jnp.dtype(A.mat.dtype), jnp.complexfloating
        )
        if (host_complex or dense_complex) and not backend_supports_complex():
            from .models.split_real import build_split_real_solver

            return build_split_real_solver(solver, A, **kept)
    return solver.create(A, **kept)
