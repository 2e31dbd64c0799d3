"""Multi-device sharding tests on the virtual 8-device CPU mesh:
batch-sharded multi-RHS solves match unsharded results and the float64
numpy references, and a row-sharded operator produces correct
(psum-reduced) normal products. This is the multi-device seam described in
SURVEY.md §2.6 / §5.8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rls_tpu as rt
from rls_tpu import solve_batched
from tools import np_reference as ref
from rls_tpu.parallel import (
    make_mesh,
    row_sharded_operator,
    shard_batch,
    solve_batched_sharded,
)


@pytest.fixture(autouse=True)
def _multi_device():
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")


def test_batch_sharded_solve_matches(rng):
    mesh = make_mesh(axis_names=("batch",))
    K = len(jax.devices()) * 2
    A = jnp.asarray(rng.normal(size=(12, 8)).astype(np.float32))
    X = jnp.asarray(rng.normal(size=(8, K)).astype(np.float32))
    B = A @ X
    s = rt.FISTA.create(A, reg=rt.L1Regularization(1e-4), iterations=25)
    X_plain = solve_batched(s, B)
    X_shard = solve_batched_sharded(s, B, mesh)
    np.testing.assert_allclose(np.asarray(X_shard), np.asarray(X_plain), atol=1e-4)


def test_row_sharded_normal_op(rng):
    mesh = make_mesh(axis_names=("rows",))
    m = len(jax.devices()) * 16
    mat = rng.normal(size=(m, 24)).astype(np.float32)
    op = row_sharded_operator(mat, mesh, axis="rows")
    x = jnp.asarray(rng.normal(size=(24,)).astype(np.float32))
    out = jax.jit(op.normal)(x)
    expected = mat.T @ (mat @ np.asarray(x))
    np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-4)


def test_row_sharded_cgnr(rng):
    mesh = make_mesh(axis_names=("rows",))
    m = len(jax.devices()) * 8
    mat = rng.normal(size=(m, 16)).astype(np.float32)
    xt = rng.normal(size=(16,)).astype(np.float32)
    b = jnp.asarray(mat @ xt)
    op = row_sharded_operator(mat, mesh, axis="rows")
    s = rt.CGNR.create(op, reg=rt.L2Regularization(1e-6), iterations=40)
    x = jax.jit(rt.solve)(s, b)
    err = float(np.linalg.norm(np.asarray(x) - xt) / np.linalg.norm(xt))
    assert err < 0.02


def test_batch_sharded_hlo_has_no_allgather(rng):
    """Collective audit: the batch-sharded solve is
    embarrassingly parallel over problems — the compiled SPMD program must
    contain NO all-gather (only the loop-condition all-reduce over the
    per-problem active flags). An all-gather would mean GSPMD decided to
    replicate per-problem state."""
    mesh = make_mesh(axis_names=("batch",))
    K = len(jax.devices()) * 2
    A = jnp.asarray(rng.normal(size=(12, 8)).astype(np.float32))
    B = A @ jnp.asarray(rng.normal(size=(8, K)).astype(np.float32))
    s = rt.FISTA.create(A, reg=rt.L1Regularization(1e-4), iterations=10)
    Bs = shard_batch(B, mesh, "batch")
    compiled = jax.jit(solve_batched).lower(s, Bs).compile()
    hlo = compiled.as_text()
    assert "all-gather" not in hlo, "batch-sharded solve emitted all-gather"
    assert "all-reduce" in hlo  # the any(active) loop condition


def test_row_sharded_hlo_psum_no_allgather(rng):
    """Row-sharded CGNR: the normal-op contraction must reduce with
    all-reduce/reduce-scatter (psum of partial AᴴAx), never all-gather
    the row-sharded operand."""
    mesh = make_mesh(axis_names=("rows",))
    m = len(jax.devices()) * 8
    mat = rng.normal(size=(m, 16)).astype(np.float32)
    b = jnp.asarray(mat @ rng.normal(size=(16,)).astype(np.float32))
    op = row_sharded_operator(mat, mesh, axis="rows")
    s = rt.CGNR.create(op, reg=rt.L2Regularization(1e-6), iterations=20)
    b_sh = jax.device_put(
        b, jax.NamedSharding(mesh, jax.sharding.PartitionSpec("rows"))
    )
    hlo = jax.jit(rt.solve).lower(s, b_sh).compile().as_text()
    assert "all-reduce" in hlo
    assert "all-gather" not in hlo, "row-sharded solve gathered A or y"


def test_2d_mesh_batch_rows_cgnr(rng):
    """2-D (batch × rows) mesh: K problems share a
    tall row-sharded dense A; problems shard over "batch". The batched
    CGNR solve must (a) keep its psum on the rows axis with NO
    all-gather, and (b) match the unsharded solve."""
    ndev = len(jax.devices())
    if ndev < 4 or ndev % 2:
        pytest.skip("needs a multi-device mesh")
    rows_nd = ndev // 2
    mesh = make_mesh(
        shape=(2, rows_nd), axis_names=("batch", "rows"),
        devices=jax.devices(),
    )
    m, n, K = 16 * rows_nd, 16, 4
    mat = rng.normal(size=(m, n)).astype(np.float32)
    Bnp = mat @ rng.normal(size=(n, K)).astype(np.float32)
    op = rt.DenseOperator(
        jax.device_put(
            jnp.asarray(mat),
            jax.NamedSharding(mesh, jax.sharding.PartitionSpec("rows", None)),
        )
    )
    s = rt.CGNR.create(op, reg=rt.L2Regularization(1e-6), iterations=30)
    Bs = jax.device_put(
        jnp.asarray(Bnp),
        jax.NamedSharding(mesh, jax.sharding.PartitionSpec("rows", "batch")),
    )
    compiled = jax.jit(solve_batched).lower(s, Bs).compile()
    hlo = compiled.as_text()
    assert "all-gather" not in hlo, "2-D mesh solve emitted all-gather"
    assert "all-reduce" in hlo or "reduce-scatter" in hlo
    got = np.asarray(jax.jit(solve_batched)(s, Bs))
    s_plain = rt.CGNR.create(
        rt.DenseOperator(jnp.asarray(mat)), reg=rt.L2Regularization(1e-6),
        iterations=30,
    )
    want = np.asarray(solve_batched(s_plain, jnp.asarray(Bnp)))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def _sep_taps(k=5):
    g = np.exp(-((np.arange(k) - k // 2) ** 2) / 2.0)
    return g / g.sum()


def _deblur_problem(rng, n, batch):
    taps = _sep_taps()
    op = rt.SeparableConvOperator.from_taps(taps, taps, im_shape=(n, n))
    A64 = ref.SepConv(taps, taps, (n, n))
    X = rng.normal(size=(n * n, batch))
    B = np.stack([A64.mv(X[:, j]) for j in range(batch)], axis=1)
    return op, A64, B.astype(np.float32)


def _sharded_fista_tv(rng, batch):
    n = 16
    op, A64, B = _deblur_problem(rng, n, batch)
    s = rt.FISTA.create(op, reg=rt.TVRegularization(1e-3, shape=(n, n),
                                                    iterations_tv=3, unroll=True),
                        iterations=4, rho=0.9, rel_tol=0.0, track_residual=False)
    tv = ref.tv_prox((n, n), None, 3)
    return s, B, lambda b: ref.fista(A64, b, tv, 1e-3, 0.9, 4, track_residual=False)


def _sharded_admm_tv(rng, batch):
    n = 16
    op, A64, B = _deblur_problem(rng, n, batch)
    s = rt.ADMM.create(op, reg=rt.TVRegularization(1e-3, shape=(n, n),
                                                   iterations_tv=3, unroll=True),
                       iterations=3, iterations_cg=3, unroll_cg=True, rho=0.1)
    tv = ref.tv_prox((n, n), None, 3)
    return s, B, lambda b: ref.admm(A64, b, [tv], [1e-3], [0.1], 3, 3)


def _sharded_cgnr(rng, batch):
    m, n = 24, 16
    A = (rng.normal(size=(m, n)) / np.sqrt(n)).astype(np.float32)
    s = rt.CGNR.create(rt.DenseOperator(jnp.asarray(A)),
                       reg=rt.L2Regularization(1e-3), iterations=10)
    B = (A @ rng.normal(size=(n, batch))).astype(np.float32)
    return s, B, lambda b: ref.cgnr(ref.Dense(A), b, 1e-3, 10, n)


def _sharded_pdhg(rng, batch):
    n = 16
    op, A64, B = _deblur_problem(rng, n, batch)
    s = rt.PDHG.create(op, reg=rt.TVRegularization(1e-3, shape=(n, n)), iterations=5)
    tau = float(s.tau)
    return s, B, lambda b: ref.pdhg(A64, b, ref.Grad8((n, n)), ref.tv_conj_8dir((n, n)),
                                    1e-3, 1.0, tau, 5)


def _sharded_pgm_dense(rng, batch):
    m, n = 24, 48
    A = (rng.normal(size=(m, n)) / np.sqrt(m)).astype(np.float32)
    s = rt.FISTA.create(rt.DenseOperator(jnp.asarray(A)), reg=rt.L1Regularization(1e-3),
                        iterations=8, rho=0.1, track_residual=False)
    B = rng.normal(size=(m, batch)).astype(np.float32)
    return s, B, lambda b: ref.fista(ref.Dense(A), b, ref.soft_threshold, 1e-3, 0.1, 8,
                                     track_residual=False)


@pytest.mark.parametrize("build", [_sharded_fista_tv, _sharded_admm_tv, _sharded_cgnr,
                                   _sharded_pdhg, _sharded_pgm_dense],
                         ids=lambda f: f.__name__[len("_sharded_"):])
def test_composed_sharded_matches_unsharded(rng, build):
    """`solve_batched_sharded` over the batch axis must match the
    unsharded composed solve and the float64 numpy reference."""
    s, B, reference = build(rng, 2 * len(jax.devices()))
    mesh = make_mesh(axis_names=("batch",))
    got = np.asarray(solve_batched_sharded(s, B, mesh))
    want = np.asarray(jax.jit(solve_batched)(s, jnp.asarray(B)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    x64 = np.stack([reference(B[:, j].astype(np.float64)) for j in range(2)], axis=1)
    assert ref.rel_err(got[:, :2], x64) < 1e-4
