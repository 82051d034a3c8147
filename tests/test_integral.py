import numpy as np
import pytest

from tpuimg import integral
from tpuimg.oracle import integral_ref


def test_integral_exact(rng):
    img = rng.integers(0, 256, (128, 192), dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(integral(img)), integral_ref(img))


def test_integral_fuzz_shapes(rng):
    # Mirrors the reference's randomized-size property test (autoTestDemo,
    # Integral/main.cpp:154-237). The full [64, 6000] range runs on the
    # accelerator via `python -m tpuimg integral-autotest` (res.log); here
    # [64, 2000) keeps the hermetic CPU run fast.
    for _ in range(8):
        h, w = rng.integers(64, 2000, size=2)
        img = rng.integers(0, 256, (int(h), int(w)), dtype=np.uint8)
        np.testing.assert_array_equal(np.asarray(integral(img)), integral_ref(img))


def test_integral_batched(rng):
    imgs = rng.integers(0, 256, (4, 33, 45), dtype=np.uint8)
    out = np.asarray(integral(imgs))
    for i in range(4):
        np.testing.assert_array_equal(out[i], integral_ref(imgs[i]))


def test_integral_tiny_and_prime_heights(rng):
    # single rows/columns, tiny frames and prime sides
    for h, w in ((1, 1), (7, 300), (24, 24), (168, 520), (25, 129)):
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        np.testing.assert_array_equal(np.asarray(integral(img)),
                                      integral_ref(img))
