"""rls_tpu — regularized least-squares solver suite in JAX.

From-scratch JAX/XLA framework with the capabilities of
RegularizedLeastSquares.jl.
"""

from . import deprecated, ops, utils
from .models import denoisers, prox, regularization
from .models.prox import (
    L1Regularization,
    L2Regularization,
    L21Regularization,
    LLRRegularization,
    NuclearRegularization,
    PositiveRegularization,
    ProjectionRegularizationTerm,
    RealRegularization,
    TVRegularization,
)
from .models.regularization import (
    AutoScaledRegularization,
    FixedParameterRegularization,
    FixedScaledRegularization,
    MaskedRegularization,
    MeasurementBasedNormalization,
    NoNormalization,
    NormalizedRegularization,
    PlugAndPlayRegularization,
    PnPRegularization,
    SystemMatrixBasedNormalization,
    TransformedRegularization,
)
from .models.regularization import find_sinks, reg_chain, sink, sink_type
from .models.split_real import (
    SplitRealSolver,
    backend_supports_complex,
    build_split_real_solver,
)
from .callbacks import (
    CompareSolutionCallback,
    StoreConvergenceCallback,
    StoreSolutionCallback,
)
from .models.solvers import (
    ADMM,
    CGNR,
    FISTA,
    OptISTA,
    POGM,
    DaxConstrained,
    DaxKaczmarz,
    DirectSolver,
    Kaczmarz,
    PDHG,
    PseudoInverse,
    SplitBregman,
    masked_vmap_scheduler,
    pcg,
    solve,
    solve_batched,
    solve_batched_fast,
    solve_batched_unrolled,
    solve_trace,
    solve_unrolled,
    solve_with_callbacks,
    solver_convergence,
    solver_solution,
)
from .ops.jacobi_svd import jacobi_svd, jacobi_svdvals, svt_jacobi
from .registry import (
    applicable_solver_list,
    create_linear_solver,
    deinit,
    is_applicable,
    linear_solver_list,
    linear_solver_list_real,
)
from .ops import (
    ConvolutionOperator,
    Grad8Operator,
    SamplingOperator,
    DirectConvOperator,
    SeparableConvOperator,
    DenseOperator,
    FFTOperator,
    FunctionOperator,
    GradientOperator,
    RadonOperator,
    IdentityOperator,
    NormalOperator,
    ProdOperator,
    PaddedCSROperator,
    SparseOperator,
    StackedOperator,
    SubsampledFFTOperator,
    SubsampledDFT2RealOperator,
    SenseDFT2RealOperator,
    WaveletOperator,
    WeightingOperator,
    max_wavelet_levels,
)
from .utils import load_state, nrmsd, power_iterations, resume, save_state, time_solver, trace

__version__ = "0.1.0"
