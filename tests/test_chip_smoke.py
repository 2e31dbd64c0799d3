"""chip_smoke.py and its helpers on the CPU: it refuses a non-GPU device,
keeps the compile-cache rule, prints the required last line, and picks
its phases; every configuration it runs matches its float64 reference at
the rehearsal sizes."""

import argparse
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from tools import bench_suite
from tools import chip_common
from tools import np_reference as ref


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        chip_common.require_gpu()


def test_main_exits_without_result_on_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """Copied away from the repository the script must fail and print no
    result."""
    shutil.copy(chip_smoke.__file__, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_compile_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert chip_common.compile_cache_dir() == os.path.join(repo, ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        chip_common.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == os.path.join(repo, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_is_left_to_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert chip_common.compile_cache_dir() == str(tmp_path)
    before = jax.config.jax_compilation_cache_dir
    chip_common.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before  # nothing set in code


def test_last_line_format():
    dev = argparse.Namespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.last_line(dev, 1)
    assert json.loads(line) == {
        "ok": True, "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                               "count": 1}}
    assert "\n" not in line


@pytest.mark.parametrize("argv, want", [
    ([], ["device", "flagship", "suite"]),
    (["--small"], ["device", "flagship", "suite"]),
    (["--four-cards"], ["device", "sharded_flagship", "row_sharded_cgnr"]),
])
def test_phases(argv, want):
    args = argparse.Namespace(four_cards="--four-cards" in argv, small="--small" in argv)
    assert chip_smoke.phases(args) == want


def test_four_cards_and_small_exclude_each_other():
    with pytest.raises(SystemExit):
        chip_smoke.main(["--four-cards", "--small"])


def test_flagship_reference_file_matches_problem():
    """bench_ref_f64.npz holds the f64 solutions of the flagship's own
    first columns; a changed problem needs tools/gen_bench_ref.py."""
    saved = np.load(chip_smoke.REF_PATH)
    k = int(saved["n_ref"])
    cfg = bench_suite.flagship()
    assert saved["x64"].shape == (cfg.B.shape[0], k)
    np.testing.assert_array_equal(saved["b"], cfg.B[:, :k])


@pytest.mark.parametrize("name", sorted(chip_smoke.SMALL))
def test_rehearsal_config_matches_reference(name):
    """Every configuration chip_smoke runs, at the rehearsal sizes, on the
    CPU: right shape, finite, and within its stated tolerance of the f64
    reference."""
    cfg = getattr(bench_suite, name)(**chip_smoke.SMALL[name])
    x = np.asarray(cfg.run(cfg.B))
    assert x.shape[1] == cfg.B.shape[1] and np.isfinite(x).all()
    k = min(2, cfg.count)
    assert ref.rel_err(x[:, :k], cfg.reference(k)) <= cfg.tol


@pytest.mark.gpu
def test_rehearsal_on_gpu(capsys):
    """The whole rehearsal on a GPU, through the script's entry point."""
    chip_smoke.main(["--small"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["device"]["platform"] == "gpu"
