import numpy as np
import pytest

from tpuimg import clahe, hist_equalize
from tpuimg.oracle import clahe_ref, hist_equalize_ref
from tpuimg.oracle.numpy_ref import (
    clahe_clip_ref,
    clahe_tile_hists_ref,
)
from tpuimg.ops.histogram import _clip_redistribute, bincount256


def test_bincount256(rng):
    img = rng.integers(0, 256, (50, 60), dtype=np.uint8)
    import jax.numpy as jnp

    hist = np.asarray(bincount256(jnp.asarray(img)))
    np.testing.assert_array_equal(hist, np.bincount(img.ravel(), minlength=256))


def test_hist_equalize_exact(rng):
    img = rng.integers(0, 256, (90, 130), dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(hist_equalize(img)), hist_equalize_ref(img))


def test_hist_equalize_lowcontrast(rng):
    img = rng.integers(100, 140, (64, 64)).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(hist_equalize(img)), hist_equalize_ref(img))


@pytest.mark.parametrize("limit", [0, 1, 5, 100])
def test_clip_redistribute_matches_serial(rng, limit):
    import jax.numpy as jnp

    hists = rng.integers(0, 300, (6, 256)).astype(np.int64)
    ref = clahe_clip_ref(hists, limit)
    out = np.asarray(_clip_redistribute(jnp.asarray(hists, jnp.int32), limit))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("shape,tiles", [((128, 128), (4, 4)), ((90, 110), (8, 8)),
                                         ((64, 200), (2, 5))])
def test_clahe_matches_oracle(rng, shape, tiles):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    xt, yt = tiles
    out = np.asarray(clahe(img, clip_limit=40.0, xtiles=xt, ytiles=yt))
    ref = clahe_ref(img, 40.0, xt, yt)
    # All-integer histograms + f32 LUT math: allow 1 gray level for
    # fma/ordering differences in the bilinear blend.
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    assert (out != ref).mean() < 0.01


def test_clahe_tile_hists_sum(rng):
    # Each tile histogram must count exactly tile_width*tile_height pixels
    # (reference debug check, clahe.cpp:43-57).
    img = rng.integers(0, 256, (90, 110), dtype=np.uint8)
    hists = clahe_tile_hists_ref(img, 8, 8)
    from tpuimg.oracle.numpy_ref import clahe_tile_geometry

    tw, th, _, _ = clahe_tile_geometry(90, 110, 8, 8)
    assert (hists.sum(axis=1) == tw * th).all()


def test_hist_equalize_batched_per_frame(rng):
    from tpuimg.oracle import hist_equalize_ref

    dark = (rng.random((32, 32)) * 60).astype(np.uint8)
    bright = (rng.random((32, 32)) * 60 + 190).astype(np.uint8)
    batch = np.stack([dark, bright])
    out = np.asarray(hist_equalize(batch))
    np.testing.assert_array_equal(out[0], hist_equalize_ref(dark))
    np.testing.assert_array_equal(out[1], hist_equalize_ref(bright))


def test_clahe_16x16_grid(rng):
    # the mapping must hold at a 16x16 tile grid (compile size must not
    # blow up with the grid)
    img = rng.integers(0, 256, (256, 384), dtype=np.uint8)
    out = np.asarray(clahe(img, clip_limit=4.0, xtiles=16, ytiles=16))
    ref = clahe_ref(img, 4.0, 16, 16)
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    assert (out != ref).mean() < 0.01


def test_apply_lut_wide_integer_tables():
    # wider integer tables (e.g. CDF counts) must come back exact too — a
    # bf16 selection would round 257 to 256
    from tpuimg.ops.histogram import apply_lut

    img = np.arange(256, dtype=np.uint8).reshape(16, 16)
    for table in [
        (np.arange(256, dtype=np.int32) * 257),          # > 255 entries
        (np.arange(256, dtype=np.int32) * -70000),       # negative, > 2^24
        (np.arange(256, dtype=np.uint16) * 256),
    ]:
        out = np.asarray(apply_lut(table, img))
        np.testing.assert_array_equal(out, table[img.ravel()].reshape(16, 16))


def test_vmap_clahe_batches(rng):
    """The ShapeError message advertises jax.vmap(tpuimg.clahe) for batches
    — verify it actually works."""
    import jax
    import jax.numpy as jnp

    import tpuimg
    from tpuimg.oracle import clahe_ref

    imgs = rng.integers(0, 256, (3, 100, 140), dtype=np.uint8)
    refs = np.stack([clahe_ref(imgs[i], 30.0, 5, 3) for i in range(3)])
    out = np.asarray(jax.vmap(
        lambda v: tpuimg.clahe(v, 30.0, 5, 3))(jnp.asarray(imgs)))
    assert np.abs(out.astype(int) - refs.astype(int)).max() <= 1


@pytest.mark.parametrize("table", [
    np.arange(256, dtype=np.uint8)[::-1].copy(),          # u8 (HE tables)
    (np.arange(256, dtype=np.int32) - 128) * 70001,       # wide ints, signed
    (np.arange(256, dtype=np.float32) * 0.37).astype(np.float32),  # f32
], ids=["u8", "int32", "float32"])
def test_apply_lut_is_exact_gather(rng, table):
    from tpuimg.ops.histogram import apply_lut

    img = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    out = np.asarray(apply_lut(table, img))
    assert out.dtype == table.dtype
    np.testing.assert_array_equal(out, table[img])


def test_bincount256_per_frame(rng):
    """The batched form: one exact histogram per leading index."""
    import jax.numpy as jnp

    frames = rng.integers(0, 256, (5, 45, 173), dtype=np.uint8)
    got = np.asarray(bincount256(jnp.asarray(frames), per_leading=True))
    assert got.shape == (5, 256) and got.dtype == np.int32
    for t in range(5):
        np.testing.assert_array_equal(
            got[t], np.bincount(frames[t].ravel(), minlength=256))


def test_bincount256_counts_past_f32_exactness():
    """int32 accumulation: a bin past 2^24 counts exactly (an f32
    accumulator would round it)."""
    import jax.numpy as jnp

    n = (1 << 24) + 3
    x = jnp.full((n,), 7, jnp.uint8)
    hist = np.asarray(bincount256(x))
    assert hist[7] == n and hist.sum() == n


@pytest.mark.parametrize("shape,grid,clip", [((37, 53), (3, 5), 2.0),
                                             ((200, 120), (2, 8), 40.0),
                                             ((64, 64), (1, 1), 4.0)])
def test_clahe_gather_mapping_geometries(rng, shape, grid, clip):
    """The per-pixel 4-corner gather against the line-by-line oracle on odd
    sizes, non-square grids and the single-tile grid."""
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    out = np.asarray(clahe(img, clip, *grid))
    ref = clahe_ref(img, clip, *grid)
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def test_map_tables_selects_corners():
    """With zero fractions the blend is exactly the (ty1, tx1) table entry;
    with unit fractions, the (ty2, tx2) entry."""
    import jax.numpy as jnp

    from tpuimg.ops.histogram import _map_tables

    tables = np.arange(4 * 256, dtype=np.float32).reshape(4, 256) * 0.5
    v = np.array([[0, 17], [255, 128]], np.uint8)
    ty1 = jnp.asarray([[0], [1]])
    tx1 = jnp.asarray([[0, 1]])
    flat = jnp.asarray(tables.reshape(-1))
    zero = jnp.zeros((1, 2), jnp.float32)
    got = np.asarray(_map_tables(flat, jnp.asarray(v), ty1, ty1, tx1, tx1, 2,
                                 zero, zero.T))
    want = tables[(np.asarray(ty1) * 2 + np.asarray(tx1)), v]
    np.testing.assert_array_equal(got, want)
    one = jnp.ones((1, 2), jnp.float32)
    ty2, tx2 = 1 - ty1, 1 - tx1
    got = np.asarray(_map_tables(flat, jnp.asarray(v), ty1, ty2, tx1, tx2, 2,
                                 one, one.T))
    np.testing.assert_array_equal(
        got, tables[(np.asarray(ty2) * 2 + np.asarray(tx2)), v])
