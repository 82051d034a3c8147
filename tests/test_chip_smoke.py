"""chip_smoke.py phases at small sizes on the CPU, and its refusal to run
without a GPU. The full-width run is the ``gpu``-marked test."""

import json

import numpy as np
import pytest

import chip_smoke


def test_op_checks_cover_every_bench_config():
    import bench

    names = {c[0] for c in chip_smoke.op_checks(s=64)}
    pairs = {"gaussian_5x5_1080p": "gaussian_r2_1080p",
             "integral_4k": "integral_4k",
             "hist_equalize_4k": "hist_equalize_4k",
             "hist_equalize_1080p_b16": "hist_equalize_1080p_b16",
             "clahe_4k_8x8": "clahe_4k_8x8",
             "guided_r8_4k": "guided_r8_4k_self",
             "guided_r8_4k_general": "guided_r8_4k_general",
             "morph_31x31_4k_batch2": "morph_open_r15_4k_b2",
             "enhance_pipeline_4k": "enhance_4k_fused_vs_staged"}
    assert {c[0] for c in bench.configs()} == set(pairs)
    assert set(pairs.values()) <= names


@pytest.fixture
def no_cache_config(monkeypatch, tmp_path):
    """Keep main() from pointing this process's compile cache at the repo:
    with the variable set, the cache helper sets nothing."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))


def test_bench_refuses_without_accelerator(capsys, no_cache_config):
    import bench

    assert bench.main() == 2
    assert "not measured" in capsys.readouterr().err


def test_op_checks_pass_small(capsys):
    assert chip_smoke.run_op_checks(s=16) == []
    out = capsys.readouterr().out
    assert out.count("[OK]") == len(chip_smoke.op_checks(s=64))
    assert "memory_analysis(" in out and "peak_bytes_in_use=" in out


def test_stream_small_not_timed_on_cpu(capsys):
    assert chip_smoke.run_stream(3, (64, 96)) is None
    assert "not measured (cpu)" in capsys.readouterr().out


def test_four_cards_small_on_virtual_devices(capsys):
    failures = chip_smoke.run_four_cards(
        frame_hw=(96, 128), batch_hw=(48, 64), n=4, morph_radius=3,
        gf_radius=4, tiles=4)
    assert failures == []
    out = capsys.readouterr().out
    # every output is spread over all four devices
    assert out.count("output shards on devices [0, 1, 2, 3]") == out.count(
        "sharded ")


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_refuses_without_gpu(capsys, no_cache_config, argv):
    assert chip_smoke.main(argv) == 2
    out = capsys.readouterr().out.strip().splitlines()
    assert "platform=cpu" in out[0]
    with pytest.raises(ValueError):
        json.loads(out[-1])  # no result line


@pytest.mark.gpu
def test_full_width_checks_on_gpu():
    assert chip_smoke.run_op_checks(s=1) == []
