"""Helpers shared by the scripts that run on the accelerator
(`chip_smoke.py`, `bench.py`, `tools/bench_suite.py`)."""

from __future__ import annotations

import os
import subprocess

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir():
    """Where JAX keeps its persistent compile cache: the directory named
    by ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself),
    otherwise ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT, ".jax_cache")


def enable_compile_cache():
    """Point JAX's persistent compile cache at `compile_cache_dir()`,
    setting nothing when ``JAX_COMPILATION_CACHE_DIR`` already does."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())


def require_gpu():
    """The first JAX device, or SystemExit when it is not a GPU: a
    measurement never falls back to the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev.platform!r} ({dev.device_kind})")
    return dev


def gpu_name_and_power_limit():
    """``nvidia-smi``'s name and power limit of each card, one line per
    card, read in a child process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def block(tree):
    import jax

    return jax.block_until_ready(tree)
