"""Profiling / tracing helpers.

The reference has no built-in profiler (SURVEY.md §5.1 — observability is
callbacks + external BenchmarkTools). Observability here:

  * `trace(logdir)` — context manager around `jax.profiler` emitting an XLA
    trace viewable in TensorBoard/Perfetto.
  * `time_solver` — compile-then-time a jitted solve, returning wall time
    per solve and per iteration (the `@benchmark` analog from
    docs/literate/howto/efficient_kaczmarz.jl).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable

import jax

__all__ = ["trace", "time_solver"]


@contextlib.contextmanager
def trace(logdir: str):
    """`with trace('/tmp/jaxtrace'): solve(...)` — captures a device trace."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_solver(solve_fn: Callable, *args, reps: int = 3, **kwargs) -> dict:
    """Compile, then time `solve_fn(*args, **kwargs)` over `reps` runs.
    Returns {"compile_s", "mean_s", "per_rep_s"}."""
    t0 = time.perf_counter()
    out = solve_fn(*args, **kwargs)
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = solve_fn(*args, **kwargs)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return {
        "compile_s": compile_s,
        "mean_s": sum(times) / len(times),
        "per_rep_s": times,
    }
