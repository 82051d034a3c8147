"""Device peaks table, the CPU refusal of every timing entry point, the card
name/power query and the compile-cache helper."""

import os
import subprocess
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from tpuimg.core import cache, timing


def _device(kind, platform="gpu"):
    return SimpleNamespace(platform=platform, device_kind=kind)


def test_peaks_known_kind():
    dev = _device("NVIDIA H100 80GB HBM3")
    peaks = timing.device_peaks(dev)
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    assert "data sheet" in peaks["source"]
    # 3.35 GB at 3.35 TB/s is one millisecond
    assert timing.sol_ms(3.0e9, 0.35e9, device=dev) == pytest.approx(1.0)


def test_peaks_unknown_kind_raises():
    with pytest.raises(RuntimeError, match="not in the peaks table"):
        timing.device_peaks(_device("NVIDIA A100-SXM4-40GB"))
    with pytest.raises(RuntimeError, match="not in the peaks table"):
        timing.sol_ms(1e9, device=_device("NVIDIA A100-SXM4-40GB"))


def test_peaks_cpu_raises():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no accelerator"):
        timing.device_peaks()
    with pytest.raises(RuntimeError, match="no accelerator"):
        timing.device_peaks(_device("cpu", platform="cpu"))


def test_time_stream_fn_refuses_cpu():
    with pytest.raises(RuntimeError, match="not measured"):
        timing.time_stream_fn(lambda x: x + 1, np.zeros((8, 8), np.float32))


def test_gpu_name_and_power_limit(monkeypatch):
    def fake_run(cmd, **kw):
        assert cmd[0] == "nvidia-smi" and "--query-gpu=name,power.limit" in cmd
        return SimpleNamespace(stdout="NVIDIA H100 80GB HBM3, 400.00 W\n")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert timing.gpu_name_and_power_limit() == \
        "NVIDIA H100 80GB HBM3, 400.00 W"

    def no_driver(cmd, **kw):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(subprocess, "run", no_driver)
    assert timing.gpu_name_and_power_limit() == "unavailable"


def test_device_line_names_the_device(monkeypatch):
    monkeypatch.setattr(timing, "gpu_name_and_power_limit",
                        lambda: "NVIDIA H100 80GB HBM3, 400.00 W")
    line = timing.device_line()
    assert "platform=cpu" in line and f"count={jax.device_count()}" in line
    assert "400.00 W" in line


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    return calls


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    calls = _record_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself; nothing set in code


def test_compile_cache_defaults_to_repo(monkeypatch):
    calls = _record_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert cache.REPO_CACHE_DIR == want
    assert cache.enable_compile_cache() == want
    assert ("jax_compilation_cache_dir", want) in calls
