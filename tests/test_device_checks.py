"""The card-side entry points refuse the CPU, and the compile cache stays
where the environment or the checkout says."""

import sys
from pathlib import Path

import pytest

from mpc_limx_control_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def test_cache_dir_follows_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_cache_dir_defaults_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = Path(compile_cache.cache_dir())
    assert path == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_chip_smoke_refuses_cpu():
    import chip_smoke

    with pytest.raises(RuntimeError, match="GPU"):
        chip_smoke.require_gpu(1)


def test_bench_refuses_cpu():
    import bench

    with pytest.raises(RuntimeError, match="GPU"):
        bench.device_info()
