"""Sharding parity on the virtual 8-device CPU mesh (conftest sets
xla_force_host_platform_device_count=8)."""

import functools

import jax
import numpy as np
import pytest

from tpuimg import erode, gaussian, hist_equalize, integral
from tpuimg.core.borders import REFLECT101, REPLICATE
from tpuimg.ops.gaussian import gaussian_ypadded
from tpuimg.ops.morphology import morph_ypadded
from tpuimg.parallel import (
    clahe_sharded,
    guided_filter_sharded,
    hist_equalize_sharded,
    integral_sharded,
    make_mesh,
    shard_rows,
    stencil_sharded,
)


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(2, 4)


def test_gaussian_sharded_matches_local(rng, mesh):
    img = rng.random((64, 96), dtype=np.float32)
    op = stencil_sharded(
        functools.partial(gaussian_ypadded, radius=2, sigma=1.5), 2, REFLECT101, mesh
    )
    out = np.asarray(jax.jit(op)(shard_rows(mesh, img)))
    ref = np.asarray(gaussian(img, 2, 1.5))
    assert np.abs(out - ref).max() < 1e-6


def test_erode_sharded_matches_local(rng, mesh):
    img = rng.integers(0, 256, (64, 80), dtype=np.uint8)
    op = stencil_sharded(
        functools.partial(morph_ypadded, radius=3, mode=0), 3, REPLICATE, mesh
    )
    out = np.asarray(jax.jit(op)(shard_rows(mesh, img)))
    np.testing.assert_array_equal(out, np.asarray(erode(img, 3)))


def test_integral_sharded_exact(rng, mesh):
    img = rng.integers(0, 256, (64, 72), dtype=np.uint8)
    out = np.asarray(jax.jit(integral_sharded(mesh))(shard_rows(mesh, img)))
    np.testing.assert_array_equal(out, np.asarray(integral(img)))


def test_he_sharded_exact(rng, mesh):
    img = rng.integers(0, 256, (64, 72), dtype=np.uint8)
    out = np.asarray(jax.jit(hist_equalize_sharded(mesh))(shard_rows(mesh, img)))
    np.testing.assert_array_equal(out, np.asarray(hist_equalize(img)))


def test_guided_sharded_matches_local(rng, mesh):
    from tpuimg import guided_filter

    I = rng.random((64, 96), dtype=np.float32)
    p = rng.random((64, 96), dtype=np.float32)
    for r in (2, 7):
        op = guided_filter_sharded(mesh, r, 1e-3)
        out = np.asarray(jax.jit(op)(shard_rows(mesh, I), shard_rows(mesh, p)))
        ref = np.asarray(guided_filter(I, p, r, 1e-3, border=REFLECT101))
        assert np.abs(out - ref).max() < 1e-5, r


def test_guided_sharded_self_guided(rng, mesh):
    # the static factory flag routes through the single-exchange 2-mean
    # specialization even under jit (object identity is lost inside a
    # trace, so `jit(op)(Is, Is)` alone can NOT reach the fast path)
    from tpuimg import guided_filter

    I = rng.random((64, 96), dtype=np.float32)
    op = guided_filter_sharded(mesh, 4, 1e-3, self_guided=True)
    Is = shard_rows(mesh, I)
    out = np.asarray(jax.jit(op)(Is))
    ref = np.asarray(guided_filter(I, I.copy(), 4, 1e-3, border=REFLECT101))
    assert np.abs(out - ref).max() < 1e-5


def test_clahe_sharded_matches_local(rng, mesh):
    from tpuimg import clahe

    # 64 rows over 4 sp shards = 16 rows/shard; tile rows th=8 align for
    # 8x8 and NOT for 6x6 (th=11) — both must match the local op
    img = rng.integers(0, 256, (64, 96), dtype=np.uint8)
    for xt, yt, clip in [(8, 8, 2.0), (6, 6, 3.0), (4, 8, 40.0)]:
        op = clahe_sharded(mesh, clip, xt, yt)
        out = np.asarray(jax.jit(op)(shard_rows(mesh, img)))
        ref = np.asarray(clahe(img, clip, xt, yt))
        d = np.abs(out.astype(int) - ref.astype(int)).max()
        assert d <= 1, (xt, yt, clip, d)  # fma/ordering tolerance


def test_clahe_sharded_pad_spans_tiles(rng, mesh):
    # dense grid on a short image: th=3, pad_top=6 >= th, so the reflect
    # extension rows span multiple y-tiles (they were once all
    # credited to tile 0 / ytiles-1, maxdiff 128 vs local)
    from tpuimg import clahe

    img = rng.integers(0, 256, (36, 64), dtype=np.uint8)
    op = clahe_sharded(mesh, 4.0, 4, 16)
    out = np.asarray(jax.jit(op)(shard_rows(mesh, img)))
    ref = np.asarray(clahe(img, 4.0, 4, 16))
    d = np.abs(out.astype(int) - ref.astype(int)).max()
    assert d <= 1, d


def test_halo_exchange_rejects_thin_shards(rng, mesh):
    img = rng.random((16, 96), dtype=np.float32)  # 4 rows/shard < radius 6
    op = stencil_sharded(
        functools.partial(gaussian_ypadded, radius=6, sigma=2.0), 6,
        REFLECT101, mesh,
    )
    with pytest.raises(ValueError, match="halo exchange"):
        jax.jit(op)(shard_rows(mesh, img))


def test_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_sharded_ops_validate_inputs(rng, mesh):
    # the sharded layer must enforce the same contracts as the local ops
    # instead of silently truncating/corrupting (round-2 review)
    from tpuimg.core.validate import DTypeError, ParamError
    from tpuimg.parallel.sharding import integral_sharded, shard_rows

    f32 = rng.random((16, 64), dtype=np.float32)
    with pytest.raises(DTypeError):
        integral_sharded(mesh)(f32)
    with pytest.raises(DTypeError):
        hist_equalize_sharded(mesh)(f32)
    with pytest.raises(ValueError):
        # ndim > 3 would fold frames into one histogram
        hist_equalize_sharded(mesh)(
            rng.integers(0, 256, (2, 3, 16, 64), dtype=np.uint8))
    with pytest.raises(ParamError):
        # tile grid needs more reflect pad than the image can provide —
        # same typed error as the single-device clahe
        clahe_sharded(mesh, 2.0, 8, 64)(
            rng.integers(0, 256, (16, 64), dtype=np.uint8))
    with pytest.raises(ParamError):
        guided_filter_sharded(mesh, 4, 0.0)
    with pytest.raises(TypeError):
        # forgotten source on a non-self-guided factory must not silently
        # run the self-guided filter
        guided_filter_sharded(mesh, 4, 1e-3)(f32)
    with pytest.raises(ParamError):
        guided_filter_sharded(mesh, 0, 1e-3)
    with pytest.raises(ValueError):
        shard_rows(mesh, rng.integers(0, 256, (3, 16, 64), dtype=np.uint8))


def test_enhance_sharded_matches_local(rng, mesh):
    # the flagship chain end-to-end over the mesh: CLAHE (psum hists) +
    # ONE halo exchange feeding gaussian+guided shard-local, vs the
    # single-device staged pipeline. CLAHE's fma-ordering tolerance (1 step)
    # passes through the tail's averaging chain without amplification.
    from tpuimg.parallel import enhance_sharded
    from tpuimg.pipeline import enhance

    img = rng.integers(0, 256, (96, 128), dtype=np.uint8)
    op = enhance_sharded(mesh, 2.0, 4, radius=2, sigma=1.5, gf_radius=4,
                         gf_eps=1e-3)
    out = np.asarray(jax.jit(op)(shard_rows(mesh, img)))
    ref = np.asarray(enhance(img, 2.0, 4, 2, 1.5, 4, 1e-3, impl="staged"))
    d = np.abs(out.astype(int) - ref.astype(int)).max()
    assert d <= 1, d


def test_enhance_sharded_arbitrary_rows(rng, mesh):
    # H=90 does not divide over sp=4: the tail pads rows with the true
    # reflect-101 extension >= (2*gf_radius + radius) deep and crops, so
    # every kept row reads only true-extension values
    import jax.numpy as jnp

    from tpuimg.parallel import enhance_sharded
    from tpuimg.pipeline import enhance

    img = rng.integers(0, 256, (90, 96), dtype=np.uint8)
    op = enhance_sharded(mesh, 4.0, 3, radius=1, sigma=1.0, gf_radius=4,
                         gf_eps=1e-2)
    out = np.asarray(jax.jit(op)(jnp.asarray(img)))
    ref = np.asarray(enhance(img, 4.0, 3, 1, 1.0, 4, 1e-2, impl="staged"))
    assert out.shape == ref.shape
    d = np.abs(out.astype(int) - ref.astype(int)).max()
    assert d <= 1, d


def test_enhance_sharded_validates_inputs(rng, mesh):
    from tpuimg.core.validate import DTypeError, ParamError
    from tpuimg.parallel import enhance_sharded

    with pytest.raises(ParamError):
        enhance_sharded(mesh, gf_eps=0.0)
    with pytest.raises(ParamError):
        enhance_sharded(mesh, radius=0)
    op = enhance_sharded(mesh, tiles=2, gf_radius=2)
    with pytest.raises(DTypeError):
        op(rng.random((64, 96), dtype=np.float32))
    with pytest.raises(ValueError, match="one .H, W. frame"):
        op(rng.integers(0, 256, (2, 64, 96), dtype=np.uint8))


def test_clahe_sharded_arbitrary_rows(rng, mesh):
    # H=70 does NOT divide over sp=4: the factory pads
    # rows to a shard multiple, masks pad rows out of every tile histogram,
    # and crops the mapped output
    import jax.numpy as jnp

    from tpuimg import clahe

    for h, grid in [(70, (4, 4)), (45, (3, 5))]:
        img = rng.integers(0, 256, (h, 96), dtype=np.uint8)
        op = clahe_sharded(mesh, 4.0, *grid)
        # an uneven H cannot be row-sharded by the caller — pass the frame
        # with default sharding; the factory pads and shard_map distributes
        out = np.asarray(jax.jit(op)(jnp.asarray(img)))
        ref = np.asarray(clahe(img, 4.0, *grid))
        assert out.shape == ref.shape
        d = np.abs(out.astype(int) - ref.astype(int)).max()
        assert d <= 1, (h, grid, d)
