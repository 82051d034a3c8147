"""The public ops are plain ``jax.jit`` functions: each traces inside a
caller's own jit (nested jit inlines) and gives the direct call's result."""

import jax
import numpy as np
import pytest

import tpuimg
from tpuimg.pipeline import enhance

CASES = [
    ("gaussian", lambda x: tpuimg.gaussian(x, 2, 1.5), "f32"),
    ("box_filter", lambda x: tpuimg.box_filter(x, 3), "f32"),
    ("guided_self", lambda x: tpuimg.guided_filter(
        x, x, 4, 1e-3, border="reflect101"), "f32"),
    ("integral", tpuimg.integral, "u8"),
    ("hist_equalize", tpuimg.hist_equalize, "u8"),
    ("clahe", lambda x: tpuimg.clahe(x, 2.0, 4, 4), "u8"),
    ("morph_open", lambda x: tpuimg.morph_open(x, 3), "u8"),
    ("enhance", lambda x: enhance(x, 2.0, 4, 2, 1.5, 4, 1e-3), "u8"),
]


@pytest.mark.parametrize("name,fn,kind", CASES, ids=[c[0] for c in CASES])
def test_op_inside_user_jit(rng, name, fn, kind):
    if kind == "u8":
        x = rng.integers(0, 256, (48, 72), dtype=np.uint8)
    else:
        x = rng.random((48, 72), dtype=np.float32)
    direct = np.asarray(fn(x))
    nested = np.asarray(jax.jit(fn)(x))
    assert nested.dtype == direct.dtype and nested.shape == direct.shape
    if direct.dtype == np.float32:
        # last-ulp reassociation of the inlined float program
        assert np.abs(nested - direct).max() <= 1e-6
    else:
        np.testing.assert_array_equal(nested, direct)
