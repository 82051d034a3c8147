"""Native loader (C++ PNG/JPEG decode + streaming prefetcher) tests."""

import numpy as np
import pytest

from tpuimg import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")


def test_png_roundtrip(rng, tmp_path):
    img = rng.integers(0, 256, (64, 96), dtype=np.uint8)
    p = str(tmp_path / "t.png")
    native.write_png(p, img)
    np.testing.assert_array_equal(native.read_image(p, gray=True), img)


def test_rgb_roundtrip(rng, tmp_path):
    img = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    p = str(tmp_path / "t.png")
    native.write_png(p, img)
    np.testing.assert_array_equal(native.read_image(p, gray=False), img)


def test_png_decode_matches_opencv(tmp_path):
    import os

    cv2 = pytest.importorskip("cv2")
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "gallery", "night_input.png")
    ours = native.read_image(path, gray=True)
    ref = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(ours, ref)


def test_stream_delivers_all_frames(rng, tmp_path):
    imgs = [rng.integers(0, 256, (32, 48), dtype=np.uint8) for _ in range(5)]
    paths = []
    for i, im in enumerate(imgs):
        p = str(tmp_path / f"f{i}.png")
        native.write_png(p, im)
        paths.append(p)
    seen = {}
    with native.FrameStream(paths, (32, 48), gray=True, threads=3,
                            capacity=2) as fs:
        for idx, frame in fs:
            seen[idx] = frame.copy()
    assert sorted(seen) == list(range(5))
    for i, im in enumerate(imgs):
        np.testing.assert_array_equal(seen[i], im)


def test_stream_resizes_to_slot(rng, tmp_path):
    img = rng.integers(0, 256, (64, 96), dtype=np.uint8)
    p = str(tmp_path / "t.png")
    native.write_png(p, img)
    with native.FrameStream([p], (32, 48), gray=True) as fs:
        frames = list(fs)
    assert frames[0][1].shape == (32, 48)


def test_stream_raises_on_corrupt_frame(rng, tmp_path):
    good = rng.integers(0, 256, (16, 24), dtype=np.uint8)
    gp = str(tmp_path / "good.png")
    native.write_png(gp, good)
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(b"\x89Pnot-really-a-png")
    with pytest.raises(IOError, match="failed to decode"):
        with native.FrameStream([gp, bad], (16, 24), gray=True, threads=1) as fs:
            list(fs)


def test_write_png_rejects_unsupported_channels(tmp_path):
    native = pytest.importorskip("tpuimg.native")
    try:
        native._load()
    except Exception:
        pytest.skip("native library unavailable")
    rgba = np.zeros((8, 8, 4), np.uint8)
    with pytest.raises(ValueError):
        native.write_png(str(tmp_path / "x.png"), rgba)
