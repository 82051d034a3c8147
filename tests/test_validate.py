import numpy as np
import pytest

import tpuimg
from tpuimg.core.params import ClaheConfig, GaussianConfig, GuidedConfig, MorphConfig
from tpuimg.core.validate import DTypeError, ParamError, ShapeError, check_image


def test_radius_zero_rejected():
    with pytest.raises(ValueError):
        tpuimg.gaussian(np.zeros((8, 8), np.float32), 0, 1.0)


def test_bad_border_rejected():
    with pytest.raises(ValueError, match="border"):
        tpuimg.box_filter(np.zeros((8, 8), np.float32), 2, border="wrap")


def test_1d_input_rejected():
    with pytest.raises(ShapeError):
        tpuimg.integral(np.zeros(16, np.uint8))


def test_check_image_dtype():
    with pytest.raises(DTypeError):
        check_image(np.zeros((4, 4), np.int64), dtypes=[np.uint8])


def test_clahe_excess_tiles_rejected():
    with pytest.raises(ValueError, match="padding"):
        tpuimg.clahe(np.zeros((4, 4), np.uint8), 2.0, 40, 40)


def test_configs_validate():
    GaussianConfig(radius=3, sigma=2.0)
    with pytest.raises(ValueError):
        GaussianConfig(radius=0)
    with pytest.raises(ValueError):
        MorphConfig(mode=2)
    with pytest.raises(ValueError):
        GuidedConfig(eps=0)
    with pytest.raises(ValueError):
        ClaheConfig(clip_limit=-1)


def test_configs_hashable_for_jit():
    assert hash(GaussianConfig()) == hash(GaussianConfig())
    assert GuidedConfig() == GuidedConfig()


def test_hist_equalize_rejects_float():
    # round-1 advisor finding: a [0,1] float image silently coerced to u8
    # became near-zeros; now a typed error
    with pytest.raises(DTypeError, match="uint8"):
        tpuimg.hist_equalize(np.random.rand(16, 16).astype(np.float32))


def test_integral_rejects_float():
    with pytest.raises(DTypeError, match="float"):
        tpuimg.integral(np.zeros((8, 8), np.float32))


def test_integral_wide_int_exact(rng):
    # non-u8 integer input takes the same exact int32 path
    img = rng.integers(0, 2**20, (33, 47)).astype(np.int32)
    out = np.asarray(tpuimg.integral(img))
    ref = np.cumsum(np.cumsum(img.astype(np.int64), 1), 0)
    np.testing.assert_array_equal(out, ref.astype(np.int32))


def test_guided_shape_mismatch_rejected(rng):
    with pytest.raises(ShapeError, match="spatial"):
        tpuimg.guided_filter(np.zeros((16, 16), np.float32),
                             np.zeros((16, 18), np.float32), 2, 1e-3)


def test_guided_auto_small_image_falls_back(rng):
    # h <= 2r: the reflect-101 window reaches past the frame twice over;
    # the filter must still succeed
    I = rng.random((20, 200), dtype=np.float32)
    out = np.asarray(tpuimg.guided_filter(I, I, 12, 1e-3, border="reflect101"))
    assert out.shape == I.shape
    from tpuimg.oracle import guided_filter_ref

    # values, not just shape: the 2r > h regime must match the oracle
    ref = guided_filter_ref(I, I, 12, 1e-3, border="reflect101")
    assert np.abs(out - ref).max() < 1e-3


def test_morphology_rejects_radius_zero():
    with pytest.raises(ParamError):
        tpuimg.erode(np.zeros((8, 8), np.uint8), 0)


def test_clahe_batched_gives_typed_error():
    with pytest.raises(ShapeError, match="vmap"):
        tpuimg.clahe(np.zeros((2, 32, 32), np.uint8), 2.0, 4, 4)


def test_clahe_vmap_works(rng):
    import jax

    from tpuimg.oracle import clahe_ref

    imgs = rng.integers(0, 256, (2, 64, 64), dtype=np.uint8)
    out = np.asarray(jax.vmap(lambda v: tpuimg.clahe(v, 2.0, 4, 4))(imgs))
    for i in range(2):
        ref = clahe_ref(imgs[i], 2.0, 4, 4)
        assert np.abs(out[i].astype(int) - ref.astype(int)).max() <= 1


def test_check_radius_numpy_int_and_bool():
    from tpuimg.core.validate import ParamError, check_radius

    check_radius(np.int64(3))  # config/sweep values are valid radii
    with pytest.raises(ParamError):
        check_radius(True)  # bool is an int subclass but not a radius
    with pytest.raises(ParamError):
        check_radius(0)


def test_impl_typo_raises():
    from tpuimg.core.validate import ParamError
    from tpuimg.pipeline import enhance

    img = np.zeros((64, 64), np.uint8)
    with pytest.raises(ParamError):
        enhance(img, impl="fsued")
    with pytest.raises(ParamError):
        enhance(img, impl="fused1")  # the removed single-launch variant


def test_guided_eps_must_be_positive():
    from tpuimg.core.validate import ParamError
    from tpuimg import guided_filter

    I = np.random.default_rng(0).random((16, 16), np.float32).astype(np.float32)
    with pytest.raises(ParamError):
        guided_filter(I, I, 2, 0.0)
