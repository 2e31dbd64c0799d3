"""Device-mesh scaling: batch sharding for multi-RHS solves and row sharding
for giant operators.

The reference's only parallelism is threads over per-column states
(/root/reference/src/MultiThreading.jl:70-78) plus threaded prox kernels.
The equivalents here follow the standard JAX recipe: build a
`Mesh`, annotate shardings with `NamedSharding`/`PartitionSpec`, and let
GSPMD insert the collectives —

  * **batch axis** ("batch"): columns of B (independent problems) are
    sharded across devices; the vmapped solver loop partitions cleanly, the
    only cross-device op is the `any(active)` reduction of the while-loop
    condition (an all-reduce over one bool per problem).
  * **row axis** ("rows"): a dense A is sharded over rows; ``A.mv`` yields a
    row-sharded y, ``A.rmv``/``normal`` contract over the sharded dimension
    so XLA inserts a psum of the partial AᴴAx over the device links; the
    CG/FISTA dot products reduce the same way.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.base import DenseOperator
from ..models.solvers.base import solve_batched

__all__ = [
    "make_mesh",
    "batch_sharding",
    "shard_batch",
    "row_sharded_operator",
    "solve_batched_sharded",
]


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("batch",),
    devices=None,
) -> Mesh:
    """Build a device mesh; defaults to all devices on one "batch" axis."""
    devices = devices if devices is not None else jax.devices()
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, tuple(axis_names))


def batch_sharding(mesh: Mesh, axis: str = "batch") -> NamedSharding:
    """Sharding for a (m, K) multi-RHS matrix: columns over the batch axis."""
    return NamedSharding(mesh, P(None, axis))


def shard_batch(B, mesh: Mesh, axis: str = "batch"):
    """Place a (m, K) problem batch with columns sharded across `axis`."""
    return jax.device_put(B, batch_sharding(mesh, axis))


def row_sharded_operator(mat, mesh: Mesh, axis: str = "rows") -> DenseOperator:
    """Dense operator with rows sharded across `axis`; rmv/normal contract
    over the sharded rows, so GSPMD inserts psum collectives."""
    sharded = jax.device_put(jnp.asarray(mat), NamedSharding(mesh, P(axis, None)))
    return DenseOperator(sharded)


def solve_batched_sharded(solver, B, mesh: Mesh, axis: str = "batch", x0=None):
    """`solve_batched` with the problem batch sharded over the mesh. The
    entire while-loop runs SPMD; per-problem convergence masking happens
    locally, only the loop condition is a global reduction."""
    B = shard_batch(jnp.asarray(B), mesh, axis)
    fn = jax.jit(solve_batched, static_argnames=())
    return fn(solver, B) if x0 is None else fn(solver, B, x0)
