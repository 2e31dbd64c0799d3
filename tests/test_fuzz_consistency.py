"""Randomized cross-path consistency sweep.

The reference's suite enumerates fixed solver × regularization combinations
(/root/reference/test/testSolvers.jl:3-125); this sweep fuzzes the same
surface with seeded random problems and asserts framework-level invariants
that must hold for EVERY combination the registry declares applicable:

  1. the returned solution is finite,
  2. it does not increase the composite objective vs the zero start,
  3. `solve` (scan path) and `solve_unrolled` (unrolled path) agree,
  4. `is_applicable` really accepts the combination that was built.

The regularizer pool includes the nested decorators (wavelet-transformed
L1, normalized/auto-scaled wrappers) so decorator plumbing is exercised
through every solver family, not just the targeted unit tests.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest

import rls_tpu as rt
from rls_tpu.models.solvers.base import solve_unrolled

# per-solver iteration budgets: enough to reach the invariant regime but
# small enough that the UNROLLED twin (straight-line XLA program, compile
# cost ∝ iterations × inner loops) compiles in seconds — ADMM/SplitBregman
# inline an inner CG and a TV prox chain per outer step
ITERS = {"ADMM": 12, "SplitBregman": 8, "PDHG": 40}

# solvers whose `done()` includes a data-dependent convergence exit: the
# unrolled fixed-schedule twin legitimately walks a few extra steps
EARLY_EXIT = {"CGNR", "SplitBregman"}


def _problem(rng, n=16, m=24):
    A = rng.normal(size=(m, n)).astype(np.float32) / np.sqrt(m)
    A += 0.3 * np.eye(m, n, dtype=np.float32)  # keep cond moderate
    x = (rng.normal(size=(n,)) * (rng.uniform(size=(n,)) < 0.5)).astype(
        np.float32
    )
    b = A @ x + 0.01 * rng.normal(size=(m,)).astype(np.float32)
    return jnp.asarray(A), jnp.asarray(b)


def _reg_pool(rng, n, kind):
    """A random regularization valid for the solver category `kind`."""
    lam = float(10.0 ** rng.uniform(-4, -2))
    if kind == "l2_only":
        return rt.L2Regularization(lam)
    choice = rng.integers(0, 4)
    if choice == 0:
        return rt.L1Regularization(lam)
    if choice == 1:
        return rt.L2Regularization(lam)
    if choice == 2:
        # wavelet-domain L1 through the nested-decorator seam
        return rt.TransformedRegularization(
            rt.L1Regularization(lam), rt.WaveletOperator((n,), wavelet="db2")
        )
    return rt.TVRegularization(lam, shape=(n,), dims=0, iterations_tv=8)


def _objective(A, b, reg, x):
    data = 0.5 * float(jnp.sum(jnp.abs(A @ x - b) ** 2))
    regs = reg if isinstance(reg, (list, tuple)) else [reg]
    val = 0.0
    for r in regs:
        v = r.value(x)
        val += float(v)
    return data + val


CASES = [
    (name, seed)
    for name in [
        "Kaczmarz",
        "CGNR",
        "FISTA",
        "OptISTA",
        "POGM",
        "ADMM",
        "SplitBregman",
        "PDHG",
        "DirectSolver",
        "PseudoInverse",
    ]
    for seed in range(3)
]


@pytest.mark.parametrize("name,seed", CASES, ids=lambda c: str(c))
def test_fuzz_solver_invariants(name, seed):
    # crc32, not hash(): the builtin is salted per process, which would
    # make each run fuzz different problems and failures irreproducible
    rng = np.random.default_rng(1000 * seed + zlib.crc32(name.encode()) % 997)
    n = 16
    A, b = _problem(rng, n=n)
    kind = "l2_only" if name in {
        "Kaczmarz", "CGNR", "DirectSolver", "PseudoInverse"
    } else "any"
    reg = _reg_pool(rng, n, kind)
    solver = rt.create_linear_solver(
        name, A, reg=reg, iterations=ITERS.get(name, 40), kwarg_warning=False
    )
    assert rt.is_applicable(solver, reg)

    x = rt.solve(solver, b)
    x_np = np.asarray(x)
    assert np.isfinite(x_np).all(), f"{name} produced non-finite entries"

    obj_x = _objective(A, b, reg, x)
    obj_0 = _objective(A, b, reg, jnp.zeros_like(x))
    assert obj_x <= obj_0 * (1 + 1e-5) + 1e-6, (
        f"{name} increased the objective: {obj_x} > {obj_0}"
    )

    x_unrolled = solve_unrolled(solver, b)
    if name in EARLY_EXIT:
        # the scan path stops at its convergence test while the unrolled
        # path always runs the full schedule, so the trajectories separate
        # at the convergence floor (~1e-4 here) by design — the invariant
        # is that both land on solutions of the same quality
        obj_u = _objective(A, b, reg, x_unrolled)
        assert obj_u <= obj_0 * (1 + 1e-5) + 1e-6
        assert abs(obj_u - obj_x) <= 1e-2 * max(obj_x, obj_u) + 1e-6, (
            f"{name}: scan ({obj_x}) and unrolled ({obj_u}) objectives differ"
        )
        np.testing.assert_allclose(
            x_np, np.asarray(x_unrolled), rtol=0.1, atol=1e-3,
            err_msg=f"{name}: scan vs unrolled solutions far apart",
        )
    else:
        np.testing.assert_allclose(
            x_np,
            np.asarray(x_unrolled),
            rtol=2e-4,
            atol=2e-5,
            err_msg=f"{name}: scan vs unrolled paths disagree",
        )


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_projection_extras(seed):
    """Projection terms riding along (reference testSolvers.jl positivity
    sweeps): the returned iterate must satisfy the constraint exactly."""
    rng = np.random.default_rng(seed)
    A, b = _problem(rng)
    reg = [rt.L1Regularization(1e-3), rt.PositiveRegularization()]
    for name in ["ADMM", "SplitBregman"]:
        solver = rt.create_linear_solver(
            name, A, reg=reg, iterations=ITERS[name], kwarg_warning=False
        )
        x = np.asarray(rt.solve(solver, b))
        assert np.isfinite(x).all()
        assert x.min() >= -1e-6, f"{name} violated positivity: {x.min()}"


@pytest.mark.parametrize(
    "name",
    [
        "Kaczmarz",
        "CGNR",
        "FISTA",
        "OptISTA",
        "POGM",
        "ADMM",
        "SplitBregman",
        "PDHG",
        "DirectSolver",
        "PseudoInverse",
    ],
)
def test_fuzz_complex_invariants(name):
    """The same invariants over ℂ (reference testSolvers.jl runs every
    solver on complex systems): finite, objective non-increasing, and the
    trace path's final iterate equals `solve`'s (both honor done())."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    n, m = 12, 18
    A = (
        (rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))) / np.sqrt(m)
        + 0.3 * np.eye(m, n)
    ).astype(np.complex64)
    x_t = (rng.normal(size=(n,)) + 1j * rng.normal(size=(n,))).astype(
        np.complex64
    )
    b = jnp.asarray(A @ x_t)
    A = jnp.asarray(A)
    lam = 1e-3
    reg = (
        rt.L2Regularization(lam)
        if name in {"Kaczmarz", "CGNR", "DirectSolver", "PseudoInverse"}
        else rt.L1Regularization(lam)
    )
    solver = rt.create_linear_solver(
        name, A, reg=reg, iterations=ITERS.get(name, 40), kwarg_warning=False
    )
    x = rt.solve(solver, b)
    x_np = np.asarray(x)
    assert np.isfinite(x_np).all().item(), f"{name}: non-finite (complex)"

    def obj(v):
        return 0.5 * float(jnp.sum(jnp.abs(A @ v - b) ** 2)) + float(
            reg.value(v)
        )

    assert obj(x) <= obj(jnp.zeros_like(x)) * (1 + 1e-5) + 1e-6

    x_tr, _ = rt.solve_trace(solver, b)
    np.testing.assert_allclose(
        x_np, np.asarray(x_tr), rtol=2e-4, atol=2e-5,
        err_msg=f"{name}: solve vs solve_trace disagree",
    )


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_cgnr_composed_matches_reference(seed):
    """The composed CGNR path (`solve_batched_fast`) must agree with the
    float64 numpy reference across random systems, shapes, batch sizes,
    λ scales, normalization strategies, constraints, and real/complex
    dtypes."""
    from tools import np_reference as ref

    rng = np.random.default_rng(zlib.crc32(f"cgnr-fused-{seed}".encode()))
    m = int(rng.integers(12, 48))
    n = int(rng.integers(8, min(m, 32)))
    P = int(rng.integers(1, 6))
    is_cplx = bool(rng.integers(0, 2))
    # keep cond(AᴴA) moderate (diagonal boost, like _problem): near-square
    # random systems are near-singular and f32 and f64 Krylov paths then
    # legitimately diverge at the κ·ε level — path agreement is only a
    # meaningful invariant in the well-conditioned regime
    if is_cplx:
        A = (rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))).astype(
            np.complex64
        ) / np.sqrt(2 * n) + 2.0 * np.eye(m, n, dtype=np.complex64)
        B = jnp.asarray(
            rng.normal(size=(m, P)) + 1j * rng.normal(size=(m, P)),
            jnp.complex64,
        )
    else:
        A = rng.normal(size=(m, n)).astype(np.float32) / np.sqrt(n) + 2.0 * (
            np.eye(m, n, dtype=np.float32)
        )
        B = jnp.asarray(rng.normal(size=(m, P)), jnp.float32)
    lam = float(10.0 ** rng.uniform(-5, -2))
    regs = [rt.L2Regularization(lam)]
    if not is_cplx and rng.integers(0, 2):
        regs.append(rt.PositiveRegularization())
    norm = [
        rt.NoNormalization(),
        rt.MeasurementBasedNormalization(),
        rt.SystemMatrixBasedNormalization(),
    ][int(rng.integers(0, 3))]
    s = rt.CGNR.create(
        rt.DenseOperator(jnp.asarray(A)),
        reg=regs if len(regs) > 1 else regs[0],
        normalize_reg=norm,
        iterations=int(rng.integers(4, 40)),
    )
    got = np.asarray(rt.solve_batched_fast(s, B))
    assert np.isfinite(got).view(np.uint8).all()
    Bn = np.asarray(B).astype(np.complex128 if is_cplx else np.float64)
    if isinstance(norm, rt.SystemMatrixBasedNormalization):
        scales = [np.sum(np.abs(A.astype(np.complex128)) ** 2) / n] * P
    elif isinstance(norm, rt.MeasurementBasedNormalization):
        scales = [np.sum(np.abs(Bn[:, j])) / m for j in range(P)]
    else:
        scales = [1.0] * P
    constr = [ref.positive] if len(regs) > 1 else []
    want = np.stack([
        ref.cgnr(ref.Dense(A), Bn[:, j], lam * scales[j], s.iterations, n, constr)
        for j in range(P)], axis=1)
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    # cond(AᴴA) ≤ ~20 by construction, so f32 must track f64 tightly
    assert err < 1e-5, (seed, m, n, P, is_cplx, err)
