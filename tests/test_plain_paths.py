"""Each op's one path against the NumPy oracle over the shapes, radii, border
cases, batches and shard-entry points that matter for it: odd and large
frames, radii past the frame size, multi-frame batches, and the
``*_ypadded`` halo entry points that ``tpuimg.parallel`` calls."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpuimg import (clahe, dilate, erode, gaussian, guided_filter,
                    hist_equalize, integral, morph_close, morph_open)
from tpuimg.oracle import (close_ref, dilate_ref, erode_ref, gaussian_ref,
                           guided_filter_ref, hist_equalize_ref, integral_ref,
                           open_ref)
from tpuimg.oracle import clahe_ref
from tpuimg.oracle.numpy_ref import clahe_tile_hists_ref


@pytest.mark.parametrize("shape", [(64, 128), (300, 700), (33, 1111)])
def test_integral_exact(rng, shape):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(integral(img)), integral_ref(img))


@pytest.mark.parametrize("radius,sigma", [(1, 1.0), (3, 2.0), (7, 3.0)])
def test_gaussian_wide_frame(rng, radius, sigma):
    img = rng.random((100, 300), dtype=np.float32)
    out = np.asarray(gaussian(img, radius, sigma))
    assert np.abs(out - gaussian_ref(img, radius, sigma)).max() < 1e-5


@pytest.mark.parametrize("radius", [1, 2, 6, 8, 15, 25, 31])
def test_erode_dilate_radii_exact(rng, radius):
    # radii across the reference's gMorphSplit / van Herk / Gil-Werman
    # ladder (image_process.cu:465) — 31 exceeds the 75-row frame
    img = rng.integers(0, 256, (75, 183), dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(erode(img, radius)),
                                  erode_ref(img, radius))
    np.testing.assert_array_equal(np.asarray(dilate(img, radius)),
                                  dilate_ref(img, radius))


@pytest.mark.parametrize("radius", [1, 3, 8, 15])
def test_open_close_exact(rng, radius):
    """Composed open/close, including the border clamp of the intermediate
    and 2r > h shapes — against pure NumPy oracles."""
    for shape in [(97, 201), (15, 33)]:
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(np.asarray(morph_open(img, radius)),
                                      open_ref(img, radius))
        np.testing.assert_array_equal(np.asarray(morph_close(img, radius)),
                                      close_ref(img, radius))


@pytest.mark.parametrize("radius,eps", [(1, 0.3), (7, 1e-3), (8, 1e-3)])
def test_guided_reflect_wide_frame(rng, radius, eps):
    I = rng.random((64, 200), dtype=np.float32)
    p = np.clip(I + 0.1 * rng.standard_normal(I.shape), 0, 1).astype(np.float32)
    out = np.asarray(guided_filter(I, p, radius, eps, border="reflect101"))
    ref = guided_filter_ref(I, p, radius, eps, border="reflect101")
    assert np.abs(out - ref).max() < 1e-3


def test_gaussian_batched_frames(rng):
    imgs = rng.random((2, 64, 96), dtype=np.float32)
    out = np.asarray(gaussian(imgs, 2, 1.5))
    for i in range(2):
        assert np.abs(out[i] - gaussian_ref(imgs[i], 2, 1.5)).max() < 1e-5


@pytest.mark.parametrize("shape", [(90, 110), (128, 256)])
def test_he_exact(rng, shape):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(hist_equalize(img)),
                                  hist_equalize_ref(img))


def test_batched_he_per_frame_exact_b16(rng):
    """Batch-16 HE: every frame matches its own single-frame result."""
    imgs = rng.integers(0, 256, (16, 60, 90), dtype=np.uint8)
    out = np.asarray(hist_equalize(imgs))
    for i in range(16):
        np.testing.assert_array_equal(out[i], hist_equalize_ref(imgs[i]))


# --- larger frames: several rows of tiles, unaligned sides ---


@pytest.mark.parametrize("shape", [(1024, 256), (700, 130), (520, 257)])
def test_gaussian_large_frames(rng, shape):
    img = rng.random(shape, dtype=np.float32)
    out = np.asarray(gaussian(img, 4, 2.0))
    assert np.abs(out - gaussian_ref(img, 4, 2.0)).max() < 1e-5


@pytest.mark.parametrize("shape,radius", [((1024, 256), 9), ((700, 130), 15),
                                          ((10, 200), 15), ((600, 90), 3)])
def test_morph_large_frames(rng, shape, radius):
    # (10, 200) r15: image shorter than the SE — pure replicate both ways
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(erode(img, radius)),
                                  erode_ref(img, radius))
    np.testing.assert_array_equal(np.asarray(dilate(img, radius)),
                                  dilate_ref(img, radius))


@pytest.mark.parametrize("shape,radius", [((1024, 256), 8), ((700, 130), 5)])
def test_open_close_large_frames(rng, shape, radius):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(morph_open(img, radius)),
                                  open_ref(img, radius))
    np.testing.assert_array_equal(np.asarray(morph_close(img, radius)),
                                  close_ref(img, radius))


@pytest.mark.parametrize("shape,radius", [((1024, 300), 6), ((700, 130), 6),
                                          ((1024, 300), 16)])
def test_guided_large_frames(rng, shape, radius):
    """r=6 takes the direct window sums, r=16 the cumsum form."""
    I = rng.random(shape, dtype=np.float32)
    p = np.clip(I + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    out = np.asarray(guided_filter(I, p, radius, 1e-3, border="reflect101"))
    ref = guided_filter_ref(I, p, radius, 1e-3, border="reflect101")
    assert np.abs(out - ref).max() < 1e-4


# --- shard entry points: halo rows supplied by the caller ---


@pytest.mark.parametrize("radius", [2, 7])
def test_stencil_ypadded_matches_local(rng, radius):
    """Feeding the reflect/replicate-padded rows of a frame to the shard
    entry points must reproduce the local op."""
    from tpuimg.ops.gaussian import gaussian_ypadded
    from tpuimg.ops.morphology import morph_ypadded

    img = rng.random((200, 300), dtype=np.float32)
    padded = np.pad(img, ((radius, radius), (0, 0)), mode="reflect")
    out = np.asarray(gaussian_ypadded(jnp.asarray(padded), radius, 1.5))
    assert np.abs(out - gaussian_ref(img, radius, 1.5)).max() < 1e-5

    u8 = rng.integers(0, 256, (200, 300), dtype=np.uint8)
    padded8 = np.pad(u8, ((radius, radius), (0, 0)), mode="edge")
    np.testing.assert_array_equal(
        np.asarray(morph_ypadded(jnp.asarray(padded8), radius, 0)),
        erode_ref(u8, radius))


@pytest.mark.parametrize("self_guided", [False, True])
def test_guided_ypadded_matches_local(rng, self_guided):
    from tpuimg.ops.guided import guided_ypadded

    r = 5
    I = rng.random((200, 260), dtype=np.float32)
    p = I if self_guided else np.clip(
        I + 0.1 * rng.standard_normal(I.shape), 0, 1).astype(np.float32)
    Ipad = jnp.asarray(np.pad(I, ((2 * r, 2 * r), (0, 0)), mode="reflect"))
    ppad = Ipad if self_guided else jnp.asarray(
        np.pad(p, ((2 * r, 2 * r), (0, 0)), mode="reflect"))
    out = np.asarray(guided_ypadded(Ipad, ppad, r, 1e-3))
    ref = guided_filter_ref(I, p, r, 1e-3, border="reflect101")
    assert np.abs(out - ref).max() < 1e-5


# --- CLAHE: tile histograms, the per-pixel gather mapping, the f32 bridge ---


@pytest.mark.parametrize("shape,grid", [((96, 160), (4, 4)),
                                        ((130, 390), (2, 3))])
def test_clahe_tile_hists_match_oracle(rng, shape, grid):
    """Tile histograms over the centered reflect-101 extension, including
    misaligned tile sizes, count exactly like the oracle."""
    from tpuimg.core.borders import reflect101_index
    from tpuimg.ops.histogram import _hist_tiles
    from tpuimg.oracle.numpy_ref import clahe_tile_geometry

    yt, xt = grid
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    h, w = shape
    tw, th, pad_left, pad_top = clahe_tile_geometry(h, w, xt, yt)
    ys = reflect101_index(np.arange(th * yt) - pad_top, h)
    xs = reflect101_index(np.arange(tw * xt) - pad_left, w)
    ext = jnp.asarray(img[np.ix_(ys, xs)])
    got = np.asarray(_hist_tiles(ext, yt, xt, th, tw))
    np.testing.assert_array_equal(got, clahe_tile_hists_ref(img, xt, yt))


def test_clahe_gather_map(rng):
    img = rng.integers(0, 256, (100, 140), dtype=np.uint8)
    out = np.asarray(clahe(img, 30.0, 5, 3))
    ref = clahe_ref(img, 30.0, 5, 3)
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def test_clahe_tiny_tiles(rng):
    img = rng.integers(0, 256, (64, 140), dtype=np.uint8)
    out = np.asarray(clahe(img, 30.0, 4, 8))  # 8-row tiles
    ref = clahe_ref(img, 30.0, 4, 8)
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("shape,grid", [((100, 140), (5, 3)),
                                        ((64, 140), (4, 8))])
def test_clahe_out_f32_matches_u8(rng, shape, grid):
    """_out_f32 emits the raw blend in [0, 255]: truncating it reproduces
    the u8 output bit-for-bit."""
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    u8 = np.asarray(clahe(img, 30.0, *grid))
    f32 = np.asarray(clahe(img, 30.0, *grid, _out_f32=True))
    assert f32.dtype == np.float32
    requant = np.clip(np.trunc(f32), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(requant, u8)


@pytest.mark.parametrize("shape", [(96, 150), (200, 260)])
def test_enhance_fused_matches_staged(rng, shape):
    """The f32-bridged enhance stays within one gray level of the staged
    composition at frame sizes that cover several CLAHE tiles."""
    from tpuimg.pipeline import enhance

    img = rng.integers(0, 256, shape, dtype=np.uint8)
    fused = np.asarray(enhance(img)).astype(int)
    staged = np.asarray(enhance(img, impl="staged")).astype(int)
    assert np.abs(fused - staged).max() <= 1


# --- the two morphology rungs ---


@pytest.mark.parametrize("radius", [41, 50])
def test_van_herk_rung_radii_exact(rng, radius):
    """Radii from _VANHERK_MIN_RADIUS up take the segmented-scan rung."""
    from tpuimg.ops import morphology as M

    assert radius >= M._VANHERK_MIN_RADIUS
    img = rng.integers(0, 256, (130, 157), dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(erode(img, radius)),
                                  erode_ref(img, radius))
    np.testing.assert_array_equal(np.asarray(morph_close(img, radius)),
                                  close_ref(img, radius))


@pytest.mark.parametrize("radius", [1, 5, 12, 25])
def test_morph_rungs_agree(rng, radius):
    """Shift-reduce and van Herk give identical extremes along either axis,
    including the replicate-padded tail of a length that is not a multiple
    of the window."""
    import functools

    import jax

    from tpuimg.ops import morphology as M

    x = jnp.asarray(np.pad(rng.integers(0, 256, (61, 83), dtype=np.uint8),
                           radius, mode="edge"))
    for axis in (0, 1):
        for fn, cum in ((jnp.minimum, jax.lax.cummin),
                        (jnp.maximum, jax.lax.cummax)):
            direct = M._shift_reduce_axis(x, radius, axis, fn)
            vh = M._van_herk_axis(x, radius, axis, fn, cumfn=cum)
            np.testing.assert_array_equal(np.asarray(direct), np.asarray(vh))
