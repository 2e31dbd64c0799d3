from .admm import ADMM
from .base import (
    LinearSolver,
    masked_vmap_scheduler,
    pcg,
    solver_convergence,
    solver_solution,
    solve,
    solve_batched,
    solve_batched_fast,
    solve_batched_unrolled,
    solve_trace,
    solve_unrolled,
    solve_with_callbacks,
)
from .cgnr import CGNR
from .dax import DaxConstrained, DaxKaczmarz
from .direct import DirectSolver, PseudoInverse
from .fista import FISTA
from .kaczmarz import Kaczmarz
from .optista import OptISTA
from .pdhg import PDHG
from .pogm import POGM
from .splitbregman import SplitBregman

__all__ = [
    "LinearSolver",
    "masked_vmap_scheduler",
    "solve",
    "solve_trace",
    "solve_with_callbacks",
    "solve_batched",
    "solve_unrolled",
    "solve_batched_unrolled",
    "solve_batched_fast",
    "pcg",
    "solver_solution",
    "solver_convergence",
    "CGNR",
    "FISTA",
    "OptISTA",
    "POGM",
    "ADMM",
    "SplitBregman",
    "Kaczmarz",
    "DaxKaczmarz",
    "DaxConstrained",
    "PDHG",
    "DirectSolver",
    "PseudoInverse",
]
