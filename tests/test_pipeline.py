"""Tests for the flagship fused pipeline (tpuimg.pipeline.enhance) and the
end-to-end `stream` CLI subcommand (the reference's always-run demo harness
pattern, e.g. Histogram/main.cpp:77-190, applied to the production chain)."""

import glob
import os

import numpy as np
import pytest

import tpuimg
from tpuimg.cli import main
from tpuimg.pipeline import enhance
from tpuimg.utils import imwrite


def test_enhance_matches_composed_stages(rng):
    """enhance(impl="staged") == clahe -> gaussian -> guided_filter -> u8,
    composed by hand from the public ops (same impls/backend)."""
    img = rng.integers(0, 256, (72, 96), dtype=np.uint8)
    out = np.asarray(enhance(img, impl="staged"))

    eq = tpuimg.clahe(img, 2.0, 8, 8)
    f = np.asarray(eq).astype(np.float32) / 255.0
    sm = tpuimg.gaussian(f, 2, 1.5)
    q = np.asarray(tpuimg.guided_filter(f, np.asarray(sm), 8, 1e-3,
                                        border="reflect101"))
    ref = np.clip(np.rint(q * 255.0), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(out, ref)


def test_enhance_fused_within_one_step_of_staged(rng):
    """The default fused path (f32 CLAHE bridge, no inter-stage u8
    round-trip) stays within 1 gray level of the staged composition."""
    img = rng.integers(0, 256, (72, 96), dtype=np.uint8)
    fused = np.asarray(enhance(img)).astype(int)
    staged = np.asarray(enhance(img, impl="staged")).astype(int)
    assert np.abs(fused - staged).max() <= 1


def test_enhance_shape_dtype_and_params(rng):
    img = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    out = enhance(img, clip_limit=3.0, tiles=4, radius=1, sigma=1.0,
                  gf_radius=2, gf_eps=1e-2)
    assert out.shape == img.shape and str(out.dtype) == "uint8"


def test_enhance_identity_scale_preserved(rng):
    """A constant frame must stay constant (no contrast invented)."""
    img = np.full((64, 64), 137, dtype=np.uint8)
    out = np.asarray(enhance(img))
    assert np.unique(out).size == 1
    # the level itself must survive: gaussian/guided preserve constants
    # exactly, only CLAHE's clipped LUT may shift it by a few levels
    assert abs(int(out[0, 0]) - 137) <= 5


def test_enhance_vmap_batches_per_frame(rng):
    """jax.vmap(enhance) batches the flagship chain with per-frame semantics
    (each frame gets its own CLAHE tile histograms) — bit-identical to the
    per-frame loop."""
    import jax
    import jax.numpy as jnp

    batch = rng.integers(0, 256, (3, 64, 96), dtype=np.uint8)
    fn = jax.vmap(lambda x: enhance(x, 2.0, 4, 2, 1.5, 4, 1e-3,
                                    impl="staged"))
    out = np.asarray(fn(jnp.asarray(batch)))
    ref = np.stack([
        np.asarray(enhance(x, 2.0, 4, 2, 1.5, 4, 1e-3, impl="staged"))
        for x in batch
    ])
    np.testing.assert_array_equal(out, ref)


@pytest.fixture
def frame_dir(tmp_path, rng):
    d = tmp_path / "frames"
    d.mkdir()
    for i in range(3):
        imwrite(str(d / f"f{i}.png"),
                rng.integers(0, 256, (48, 64), dtype=np.uint8))
    return d


def test_cli_stream_enhance(frame_dir, tmp_path, capsys):
    out_dir = str(tmp_path / "out")
    assert main(["stream", str(frame_dir / "*.png"), "--op", "enhance",
                 "--out", out_dir, "--width", "64", "--height", "48"]) == 0
    written = sorted(glob.glob(os.path.join(out_dir, "*.png")))
    assert len(written) == 3
    assert "3 frames" in capsys.readouterr().out


def test_cli_stream_gaussian_rounding(frame_dir, tmp_path):
    """The stream gaussian op must use the library's rint+clip convention,
    not truncation (round-1 advisor finding)."""
    from tpuimg.utils import imread_gray

    out_dir = str(tmp_path / "outg")
    assert main(["stream", str(frame_dir / "f0.png"), "--op", "gaussian",
                 "--radius", "2", "--out", out_dir,
                 "--width", "64", "--height", "48"]) == 0
    got = imread_gray(os.path.join(out_dir, "f0.png"))
    src = imread_gray(str(frame_dir / "f0.png")).astype(np.float32) / 255.0
    ref = np.clip(np.rint(np.asarray(tpuimg.gaussian(src, 2, 1.5)) * 255.0),
                  0, 255).astype(np.uint8)
    np.testing.assert_array_equal(got, ref)
