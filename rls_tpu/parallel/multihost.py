"""Multi-host initialization helpers.

The reference has no distributed backend at all (SURVEY.md §2.6/§5.8 — its
only parallelism is threads). The scaling story here is:

  1. `initialize_multihost()` — `jax.distributed.initialize` on every host
     (coordinator address, process count and id given explicitly, or
     auto-detected where the cluster environment provides them);
  2. build a global mesh over all devices (`make_mesh`);
  3. shard the problem batch ("batch" axis: no cross-problem
     communication except the loop-condition all-reduce) and/or operator
     rows ("rows" axis: psum of AᴴAx partials and CG dot products);
  4. run the same jitted solve — GSPMD inserts the collectives.

Single-process multi-device (one host, N devices) needs no
initialization; these helpers are no-ops there.
"""

from __future__ import annotations

from typing import Optional

import jax

__all__ = ["initialize_multihost", "is_multihost", "global_mesh"]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the JAX distributed runtime (no-op if already running or
    in an explicitly single-process context). Real initialization
    failures (bad
    coordinator, rendezvous timeout) PROPAGATE — swallowing them would
    silently degrade a multi-host job to one process."""
    if jax.distributed.is_initialized():
        return
    if num_processes == 1:
        return
    if (
        coordinator_address is None
        and num_processes is None
        and process_id is None
    ):
        # all-None: rely on jax's cluster auto-detection (SLURM, …). Failure here means "no cluster environment" — the
        # documented single-process no-op — so it alone may be swallowed.
        try:
            jax.distributed.initialize()
        except (RuntimeError, ValueError):
            pass
        return
    # explicit configuration: a failure is a real error (bad coordinator,
    # rendezvous timeout) and must PROPAGATE — swallowing it would silently
    # degrade a multi-host job to one process
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_multihost() -> bool:
    return jax.process_count() > 1


def global_mesh(axis_names=("batch",), shape=None):
    """Mesh over ALL devices of the (possibly multi-host) runtime."""
    from .mesh import make_mesh

    return make_mesh(shape=shape, axis_names=axis_names, devices=jax.devices())
