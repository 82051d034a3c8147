"""Randomized shape/parameter fuzzing across every op (generalizes the
reference's autoTestDemo, Integral/main.cpp:154-237, to the whole API)."""

import numpy as np
import pytest

import tpuimg
from tpuimg.oracle import (
    clahe_ref,
    dilate_ref,
    erode_ref,
    gaussian_ref,
    guided_filter_ref,
    hist_equalize_ref,
    integral_ref,
)


def test_fuzz_all_ops(rng):
    for trial in range(8):
        h = int(rng.integers(16, 260))
        w = int(rng.integers(16, 260))
        u8 = rng.integers(0, 256, (h, w), dtype=np.uint8)
        f32 = rng.random((h, w), dtype=np.float32)

        np.testing.assert_array_equal(
            np.asarray(tpuimg.integral(u8)), integral_ref(u8)
        )
        np.testing.assert_array_equal(
            np.asarray(tpuimg.hist_equalize(u8)), hist_equalize_ref(u8)
        )

        r = int(rng.integers(1, min(8, h // 2, w // 2)))
        sigma = float(rng.uniform(0.5, 4.0))
        assert np.abs(
            np.asarray(tpuimg.gaussian(f32, r, sigma)) - gaussian_ref(f32, r, sigma)
        ).max() < 1e-5

        np.testing.assert_array_equal(
            np.asarray(tpuimg.erode(u8, r)), erode_ref(u8, r)
        )
        np.testing.assert_array_equal(
            np.asarray(tpuimg.dilate(u8, r)), dilate_ref(u8, r)
        )

        eps = float(rng.uniform(1e-4, 0.5))
        q = np.asarray(tpuimg.guided_filter(f32, f32, r, eps))
        assert np.abs(q - guided_filter_ref(f32, f32, r, eps)).max() < 1e-3


def test_fuzz_clahe_geometries(rng):
    for trial in range(5):
        h = int(rng.integers(40, 300))
        w = int(rng.integers(40, 300))
        xt = int(rng.integers(2, 9))
        yt = int(rng.integers(2, 9))
        clip = float(rng.uniform(0.5, 60.0))
        u8 = rng.integers(0, 256, (h, w), dtype=np.uint8)
        out = np.asarray(tpuimg.clahe(u8, clip, xt, yt))
        ref = clahe_ref(u8, clip, xt, yt)
        assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1, (
            h, w, xt, yt, clip,
        )


def test_fuzz_morph_large_radii(rng):
    # spans the van Herk path and radii near/above image size
    for radius in (8, 12, 20, 31):
        h = int(rng.integers(radius + 2, 4 * radius))
        w = int(rng.integers(radius + 2, 4 * radius))
        u8 = rng.integers(0, 256, (h, w), dtype=np.uint8)
        np.testing.assert_array_equal(
            np.asarray(tpuimg.erode(u8, radius)), erode_ref(u8, radius)
        )
