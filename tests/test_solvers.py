"""Solver correctness, mirroring /root/reference/test/testSolvers.jl:

  * every registered solver recovers a tiny 3×2 real and complex system to
    rtol 0.1 (testSolvers.jl:3-43)
  * AHA-only construction (:45-65)
  * compressed-sensing FFT problem with L1 for the prox-gradient family and
    ADMM, incl. gradient restart and MeasurementBasedNormalization scale
    invariance (:67-125)
  * ADMM vary_rho both directions (:127-171)
  * SplitBregman inner/outer split ≡ ADMM (:174-201)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rls_tpu as rt
from rls_tpu import solve

ALL_SOLVERS = [
    "Kaczmarz",
    "CGNR",
    "FISTA",
    "OptISTA",
    "POGM",
    "ADMM",
    "SplitBregman",
    "DirectSolver",
    "PseudoInverse",
]

L2_ONLY = {"Kaczmarz", "CGNR", "DirectSolver", "PseudoInverse"}


def _tiny_problem(rng, complex_=False):
    if complex_:
        A = (rng.normal(size=(3, 2)) + 1j * rng.normal(size=(3, 2))).astype(
            np.complex64
        )
        x = (rng.normal(size=(2,)) + 1j * rng.normal(size=(2,))).astype(np.complex64)
    else:
        A = rng.normal(size=(3, 2)).astype(np.float32)
        x = rng.normal(size=(2,)).astype(np.float32)
    return jnp.asarray(A), jnp.asarray(x), jnp.asarray(A @ x)


def _reg_for(name):
    if name in L2_ONLY:
        return rt.L2Regularization(1e-4)
    return rt.L1Regularization(1e-4)


@pytest.mark.parametrize("name", ALL_SOLVERS)
@pytest.mark.parametrize("complex_", [False, True])
def test_recover_tiny_system(rng, name, complex_):
    A, xt, b = _tiny_problem(rng, complex_)
    s = rt.create_linear_solver(
        name, A, reg=_reg_for(name), iterations=200, kwarg_warning=False
    )
    x = solve(s, b)
    err = float(jnp.linalg.norm(x - xt) / jnp.linalg.norm(xt))
    assert err < 0.1, f"{name}: {err}"


def test_direct_solvers_jacobi_dispatch(rng):
    """Real-f32 direct solvers must ride the one-sided Jacobi SVD (its
    rotations use no matmul unit) and still match the f64
    regularized normal solve; svd_method='lu' keeps the factorization
    path (reference Direct.jl:101-133)."""
    A = rng.normal(size=(48, 32)).astype(np.float32) / 6
    x = rng.normal(size=(32,)).astype(np.float32)
    b = A @ x
    lam = 1e-3
    A64 = A.astype(np.float64)
    want = np.linalg.solve(A64.T @ A64 + lam * np.eye(32), A64.T @ b)
    for cls in (rt.DirectSolver, rt.PseudoInverse):
        s = cls.create(jnp.asarray(A), reg=rt.L2Regularization(lam))
        assert s.U is not None  # Jacobi route precomputed at create
        got = np.asarray(solve(s, jnp.asarray(b)))
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err < 1e-4, f"{cls.__name__}: {err}"
    # forced LU path stays available and agrees at f32 precision
    s_lu = rt.DirectSolver.create(
        jnp.asarray(A), reg=rt.L2Regularization(lam), svd_method="lu"
    )
    assert s_lu.U is None
    got = np.asarray(solve(s_lu, jnp.asarray(b)))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-3


def test_direct_solver_wide_matrix_jacobi(rng):
    """m < n dispatch factors Aᵀ (thin-SVD swap) — solution must match
    the f64 Tikhonov-filtered pinv."""
    A = rng.normal(size=(24, 40)).astype(np.float32) / 5
    b = rng.normal(size=(24,)).astype(np.float32)
    lam = 1e-3
    s = rt.PseudoInverse.create(jnp.asarray(A), reg=rt.L2Regularization(lam))
    got = np.asarray(solve(s, jnp.asarray(b)))
    u, sv, vt = np.linalg.svd(A.astype(np.float64), full_matrices=False)
    want = vt.T @ (sv / (sv**2 + lam) * (u.T @ b))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4


def test_solve_matrix_b_dispatches_to_batched(rng):
    """`solve(solver, B)` with a matrix B must route through the
    multi-RHS scheduler, column-per-problem with an hcat-shaped result —
    the reference's `solve!(solver, B::AbstractMatrix)` dispatch
    (/root/reference/src/MultiThreading.jl:30-43, :82)."""
    from rls_tpu.models.solvers import solve_batched

    A, _, b = _tiny_problem(rng)
    B = jnp.stack([b, 2.0 * b, -b], axis=1)
    s = rt.create_linear_solver(
        "CGNR", A, reg=rt.L2Regularization(1e-4), iterations=50,
        kwarg_warning=False,
    )
    X = solve(s, B)
    assert X.shape == (A.shape[1], 3)
    np.testing.assert_allclose(
        np.asarray(X), np.asarray(solve_batched(s, B)), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(X[:, 0]), np.asarray(solve(s, b)), rtol=1e-5
    )


@pytest.mark.parametrize("name", ["CGNR", "FISTA", "OptISTA", "POGM", "ADMM"])
def test_aha_only_construction(rng, name):
    """Solvers built from the normal operator alone (testSolvers.jl:45-65):
    b is then the back-projection Aᴴb."""
    A, xt, b = _tiny_problem(rng)
    AHA = rt.DenseOperator(A.T @ A)
    s = rt.create_linear_solver(
        name, AHA=AHA, reg=_reg_for(name), iterations=200, kwarg_warning=False
    )
    x = solve(s, A.T @ b)
    err = float(jnp.linalg.norm(x - xt) / jnp.linalg.norm(xt))
    assert err < 0.1


def _cs_problem(rng, n=256, npeaks=3, frac=0.5):
    """1-D compressed sensing mirroring the reference's convex test problem
    (testSolvers.jl:67-81): few positive peaks, half-sampled unitary DFT."""
    x = np.zeros(n, np.complex64)
    nz = rng.choice(n, size=npeaks, replace=False)
    x[nz] = rng.uniform(0.3, 1.0, size=npeaks)
    idx = np.sort(np.unique(rng.choice(n, size=int(n * frac))))
    op = rt.SubsampledFFTOperator(
        sample_idx=jnp.asarray(idx, jnp.int32), im_shape=(n,)
    )
    xt = jnp.asarray(x)
    return op, xt, op.mv(xt)


@pytest.mark.parametrize(
    "name,kw",
    [
        ("FISTA", {}),
        ("FISTA", {"restart": "gradient"}),
        ("OptISTA", {}),
        ("POGM", {}),
        ("POGM", {"restart": "gradient"}),
        ("ADMM", {}),
    ],
)
def test_compressed_sensing_l1(rng, name, kw):
    op, xt, b = _cs_problem(rng)
    s = rt.create_linear_solver(
        name,
        op,
        reg=rt.L1Regularization(1e-3),
        iterations=200,
        kwarg_warning=False,
        **kw,
    )
    x = solve(s, b)
    err = float(jnp.linalg.norm(x - xt) / jnp.linalg.norm(xt))
    assert err < 0.1, f"{name} {kw}: {err}"


def test_measurement_normalization_scale_invariance(rng):
    """λ normalized by ‖b‖₁/len(b) makes the solution scale-equivariant
    (testSolvers.jl:95-125)."""
    op, xt, b = _cs_problem(rng)
    s = rt.FISTA.create(
        op,
        reg=rt.L1Regularization(1e-3),
        iterations=100,
        normalize_reg=rt.MeasurementBasedNormalization(),
    )
    x1 = solve(s, b)
    x2 = solve(s, 10.0 * b)
    # norm-based comparison (Julia isapprox semantics)
    rel = float(jnp.linalg.norm(10.0 * x1 - x2) / jnp.linalg.norm(x2))
    assert rel < 2e-2


@pytest.mark.parametrize("vary", ["balance", "PnP"])
def test_admm_vary_rho(rng, vary):
    A, xt, b = _tiny_problem(rng)
    s = rt.ADMM.create(
        A, reg=rt.L1Regularization(1e-4), iterations=150, vary_rho=vary, rho=1e-2
    )
    x = solve(s, b)
    err = float(jnp.linalg.norm(x - xt) / jnp.linalg.norm(xt))
    assert err < 0.1


def test_splitbregman_equals_admm_single_outer(rng):
    """SplitBregman with iterations=1 is ADMM (SplitBregman docstring,
    reference SplitBregman.jl:74)."""
    A, xt, b = _tiny_problem(rng)
    admm = rt.ADMM.create(A, reg=rt.L1Regularization(1e-3), iterations=50, rho=0.1)
    sb = rt.SplitBregman.create(
        A,
        reg=rt.L1Regularization(1e-3),
        iterations=1,
        iterations_inner=50,
        rho=0.1,
    )
    xa = solve(admm, b)
    xs = solve(sb, b)
    np.testing.assert_allclose(np.asarray(xa), np.asarray(xs), atol=2e-3)


def test_splitbregman_multi_term(rng):
    """Two reg terms with gradient trafo (multi-term splitting)."""
    n = 16
    img = np.zeros((n, n), np.float32)
    img[4:12, 4:12] = 1.0
    xt = jnp.asarray(img.reshape(-1))
    A = jnp.asarray(rng.normal(size=(3 * n * n // 2, n * n)).astype(np.float32)) / n
    b = A @ xt
    grad = rt.GradientOperator(im_shape=(n, n), _dtype=jnp.float32)
    eye = rt.IdentityOperator(n * n, jnp.float32)
    s = rt.SplitBregman.create(
        A,
        reg=[rt.L1Regularization(1e-4), rt.L1Regularization(1e-4)],
        reg_trafo=[eye, grad],
        iterations=3,
        iterations_inner=10,
        rho=[0.1, 0.1],
    )
    x = solve(s, b)
    err = float(jnp.linalg.norm(x - xt) / jnp.linalg.norm(xt))
    assert err < 0.1


def test_solver_list_and_applicability():
    assert len(rt.linear_solver_list()) >= 9
    regs = [rt.L1Regularization(0.1)]
    app = rt.applicable_solver_list(regs)
    assert rt.FISTA in app and rt.CGNR not in app
    regs2 = [rt.L2Regularization(0.1)]
    assert rt.Kaczmarz in rt.applicable_solver_list(regs2)


def test_kwarg_filter_warning(rng):
    A, xt, b = _tiny_problem(rng)
    with pytest.warns(UserWarning, match="filtered out"):
        rt.create_linear_solver(
            "CGNR", A, reg=rt.L2Regularization(1e-4), bogus_kwarg=1
        )


def test_positive_projection_with_cgnr(rng):
    A, xt, b = _tiny_problem(rng)
    xt_pos = jnp.abs(xt)
    b = A @ xt_pos
    s = rt.CGNR.create(
        A,
        reg=[rt.L2Regularization(1e-4), rt.PositiveRegularization()],
        iterations=50,
    )
    x = solve(s, b)
    assert float(jnp.min(x)) >= 0.0


def test_x0_warm_start(rng):
    A, xt, b = _tiny_problem(rng)
    s = rt.FISTA.create(A, reg=rt.L1Regularization(1e-5), iterations=10)
    x_cold = solve(s, b)
    x_warm = solve(s, b, xt)  # start at the solution
    err_warm = float(jnp.linalg.norm(x_warm - xt) / jnp.linalg.norm(xt))
    assert err_warm < 0.05


def test_admm_unroll_cg_matches(rng):
    """ADMM with the masked python-unrolled inner CG must match the
    while-loop CG (the control-flow-free mode of the unrolled drivers)."""
    A, xt, b = _tiny_problem(rng)
    common = dict(reg=rt.L1Regularization(1e-4), iterations=30,
                  iterations_cg=8, kwarg_warning=False)
    s1 = rt.create_linear_solver("ADMM", A, **common)
    s2 = rt.create_linear_solver("ADMM", A, unroll_cg=True, **common)
    x1 = np.asarray(solve(s1, b))
    x2 = np.asarray(solve(s2, b))
    np.testing.assert_allclose(x2, x1, rtol=0, atol=1e-4)


def test_splitbregman_unrolled_runs_all_inner_steps(rng):
    """solve_unrolled must run iterations x iterations_inner steps for
    SplitBregman (step() is one INNER iteration), matching the while-loop
    driver. Regression: it used to run only `iterations` steps."""
    from rls_tpu.models.solvers import solve_unrolled

    A, xt, b = _tiny_problem(rng)
    s = rt.SplitBregman.create(
        A, reg=rt.L1Regularization(1e-4), iterations=3, iterations_inner=12,
        iterations_cg=8, unroll_cg=True, rho=0.1,
    )
    assert s.total_steps == 36
    x_u = np.asarray(solve_unrolled(s, b))
    x_w = np.asarray(solve(s, b))
    np.testing.assert_allclose(x_u, x_w, rtol=0, atol=1e-4)


def test_solve_trace_runs_all_splitbregman_steps(rng):
    """solve_trace must scan total_steps (= iterations x iterations_inner
    for SplitBregman), matching solve. Regression: it scanned only the
    outer count."""
    from rls_tpu.models.solvers import solve_trace

    A, xt, b = _tiny_problem(rng)
    s = rt.SplitBregman.create(
        A, reg=rt.L1Regularization(1e-4), iterations=3, iterations_inner=10,
        iterations_cg=6, rho=0.1,
    )
    x_t, trace = solve_trace(s, b)
    x_w = solve(s, b)
    np.testing.assert_allclose(np.asarray(x_t), np.asarray(x_w), atol=1e-5)


def test_cgnr_refined_beats_f32_stall_on_illcond(rng):
    """Iterative refinement (solve_cgnr_refined) must converge an
    ill-conditioned system to the f64 regularized solution within 1e-4 in
    pure f32 — where a single 200-iteration f32 CG run stalls ~1e-2
    (the PARITY illcond config; reference runs Float64 freely,
    /root/reference/test/testSolvers.jl:240-261)."""
    from rls_tpu.models.solvers.cgnr import solve_cgnr_refined

    m = 64
    raw = rng.normal(size=(m, m)) / np.sqrt(m)
    lam = 1e-6
    # f64 ground truth: the converged regularized normal-equation solution
    x_true = rng.normal(size=(m,))
    b64 = raw @ x_true
    x64 = np.linalg.solve(raw.T @ raw + lam * np.eye(m), raw.T @ b64)

    A = jnp.asarray(raw, jnp.float32)
    b = jnp.asarray(b64, jnp.float32)
    s = rt.CGNR.create(
        rt.DenseOperator(A), reg=rt.L2Regularization(lam), iterations=200
    )
    x_plain = np.asarray(jax.jit(lambda bb: rt.solve(s, bb))(b))
    x_ref = np.asarray(
        jax.jit(lambda bb: solve_cgnr_refined(s, bb, rounds=4))(b)
    )
    err_plain = np.linalg.norm(x_plain - x64) / np.linalg.norm(x64)
    err_ref = np.linalg.norm(x_ref - x64) / np.linalg.norm(x64)
    assert err_ref < 1e-4, (err_ref, err_plain)
    assert err_ref < err_plain / 10


def test_cgnr_refined_matches_plain_when_converged(rng):
    """On a well-conditioned system refinement is a no-op beyond f32
    noise (corrections are ~0)."""
    from rls_tpu.models.solvers.cgnr import solve_cgnr_refined

    m = 32
    raw = rng.normal(size=(m, m)) / np.sqrt(m)
    Anp = 0.5 * np.eye(m) + 0.25 * raw
    A = jnp.asarray(Anp, jnp.float32)
    x_true = rng.normal(size=(m,))
    b = jnp.asarray(Anp @ x_true, jnp.float32)
    s = rt.CGNR.create(
        rt.DenseOperator(A), reg=rt.L2Regularization(1e-6), iterations=100
    )
    x_plain = np.asarray(rt.solve(s, b))
    x_ref = np.asarray(solve_cgnr_refined(s, b, rounds=3))
    np.testing.assert_allclose(x_ref, x_plain, atol=1e-5)


def test_deprecated_shims(rng):
    """Reference deprecated.jl shims: positional-x ctor warns and
    forwards, vec_reg warns and wraps, ConstraintTransformedRegularization
    raises with the upstream guidance."""
    from rls_tpu.deprecated import (
        ConstraintTransformedRegularization,
        create_linear_solver_x,
        vec_reg,
    )

    A = jnp.asarray(rng.normal(size=(6, 4)), jnp.float32)
    with pytest.warns(DeprecationWarning, match="x0"):
        s = create_linear_solver_x(
            "CGNR", A, jnp.zeros((4,)), reg=rt.L2Regularization(1e-4),
            kwarg_warning=False,
        )
    assert isinstance(s, rt.CGNR)
    l1 = rt.L1Regularization(0.1)
    with pytest.warns(DeprecationWarning):
        assert vec_reg(l1) == [l1]
    with pytest.warns(DeprecationWarning):
        assert vec_reg([l1]) == [l1]
    with pytest.raises(RuntimeError, match="separate inputs"):
        ConstraintTransformedRegularization(l1)


def test_cgnr_unrolled_past_convergence_stays_finite(rng):
    """CG reaches exact convergence in ≤ n steps on a small system; the
    unrolled (no-early-exit) path keeps stepping past it, and the raw
    0/0 in α = ζ/denom used to poison it with NaNs. The guarded step is
    the identity at convergence, so unrolled == scan."""
    from rls_tpu.models.solvers.base import solve_unrolled

    A = jnp.asarray(rng.normal(size=(24, 16)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=(24,)).astype(np.float32))
    s = rt.CGNR.create(A, reg=rt.L2Regularization(1e-3), iterations=60)
    x_scan = np.asarray(solve(s, b))
    x_unrolled = np.asarray(solve_unrolled(s, b))
    assert np.isfinite(x_unrolled).all()
    np.testing.assert_allclose(x_unrolled, x_scan, rtol=1e-5, atol=1e-6)


def test_fista_gradient_mapping_restart_beats_reference_rule(rng):
    """restart="gradient_mapping" (composite-gradient O'Donoghue–Candès
    test) must converge on LASSO where the reference's raw-∇f rule
    degrades FISTA to ISTA-rate (docs/API_PARITY.md §5) — and must equal
    the raw rule's behavior on a smooth (L2) problem, where the two
    tests provably coincide."""
    from rls_tpu.models.solvers import solve_unrolled

    m, n = 128, 256
    A = jnp.asarray(rng.normal(size=(m, n)) / np.sqrt(m), jnp.float32)
    xt = jnp.asarray(
        rng.normal(size=(n,)) * (rng.uniform(size=(n,)) < 0.05), jnp.float32
    )
    b = A @ xt
    L = float(np.linalg.norm(np.asarray(A), 2) ** 2)

    def err(restart):
        s = rt.FISTA.create(
            rt.DenseOperator(A), reg=rt.L1Regularization(1e-4),
            iterations=500, rho=0.95 / L, restart=restart,
            track_residual=False,
        )
        x = np.asarray(solve_unrolled(s, b))
        return float(np.linalg.norm(x - np.asarray(xt))
                     / np.linalg.norm(np.asarray(xt)))

    e_ref = err("gradient")
    e_map = err("gradient_mapping")
    assert e_map < 0.1, e_map
    assert e_map < 0.3 * e_ref, (e_map, e_ref)  # raw rule stalls here

    # smooth problem: the tests coincide (res ∝ y − x⁺ with no prox)
    s_g = rt.FISTA.create(
        rt.DenseOperator(A), reg=rt.L2Regularization(1e-5),
        iterations=60, rho=0.95 / L, restart="gradient",
        track_residual=False,
    )
    s_m = rt.FISTA.create(
        rt.DenseOperator(A), reg=rt.L2Regularization(1e-5),
        iterations=60, rho=0.95 / L, restart="gradient_mapping",
        track_residual=False,
    )
    x_g = np.asarray(solve_unrolled(s_g, b))
    x_m = np.asarray(solve_unrolled(s_m, b))
    np.testing.assert_allclose(x_m, x_g, rtol=0, atol=1e-5)
