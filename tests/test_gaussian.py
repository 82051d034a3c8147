import numpy as np
import pytest

from tpuimg import gaussian
from tpuimg.oracle import gaussian_ref


@pytest.mark.parametrize("radius,sigma", [(1, 1.0), (2, 1.5), (3, 0.8), (7, 4.0)])
def test_gaussian_matches_oracle(rng, radius, sigma):
    img = rng.random((72, 100), dtype=np.float32)
    out = np.asarray(gaussian(img, radius, sigma))
    ref = gaussian_ref(img, radius, sigma)
    assert np.abs(out - ref).max() < 1e-5


def test_gaussian_batched(rng):
    imgs = rng.random((3, 40, 56), dtype=np.float32)
    out = np.asarray(gaussian(imgs, 2, 1.2))
    for i in range(3):
        ref = gaussian_ref(imgs[i], 2, 1.2)
        assert np.abs(out[i] - ref).max() < 1e-5


def test_gaussian_odd_sizes(rng):
    # Non-tile-aligned spatial dims (reference supports arbitrary W, H).
    img = rng.random((37, 53), dtype=np.float32)
    out = np.asarray(gaussian(img, 4, 2.0))
    ref = gaussian_ref(img, 4, 2.0)
    assert np.abs(out - ref).max() < 1e-5
