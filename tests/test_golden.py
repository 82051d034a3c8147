"""Golden-image regression on a real photograph (SURVEY §4.3).

The reference writes per-variant result PNGs from its demos and re-reads them
as visual fixtures (GaussianFilter/gaussian.cu:641-662, Histogram/
main.cpp:171-185, Morphology/main.cpp:92-95, GuidedFilter/main.cpp:295-304).
Here the fixture is the night scene in ``docs/gallery/`` (a 1456x816 gray
frame) with the gallery's result PNGs beside it. Each op is checked on it
against the NumPy oracle, against OpenCV where OpenCV computes the same
thing, and against the stored gallery output.

Established facts (KNOWN_DIVERGENCES.md):
- Our HE uses the CUDA table formula rint(min(255, cdf*256/N))
  (image_process.cu:115-123), which differs from cv2.equalizeHist's
  (cdf-cdfmin)*255/(N-cdfmin): 3 gray levels on this frame.
- The gallery's gaussian/guided/enhance PNGs went through a float → u8
  rint, so a last-ulp difference in summation order can move a pixel one
  gray level.
"""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import tpuimg
from tpuimg.oracle import (clahe_ref, close_ref, dilate_ref, erode_ref,
                           gaussian_ref, guided_filter_ref, hist_equalize_ref,
                           integral_ref, open_ref)

GALLERY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs", "gallery")


def _png(name):
    img = cv2.imread(os.path.join(GALLERY, name), cv2.IMREAD_UNCHANGED)
    assert img is not None, f"missing fixture docs/gallery/{name}"
    return img


@pytest.fixture(scope="module")
def night():
    return _png("night_input.png")


def _u8(f):
    return np.clip(np.rint(f * 255.0), 0, 255).astype(np.uint8)


def _maxdiff(a, b):
    return np.abs(np.asarray(a).astype(np.float64)
                  - np.asarray(b).astype(np.float64)).max()


def test_he_golden_night(night):
    ours = np.asarray(tpuimg.hist_equalize(night))
    np.testing.assert_array_equal(ours, hist_equalize_ref(night))
    np.testing.assert_array_equal(ours, _png("night_he.png"))
    # cv2's table formula differs from the CUDA one (module docstring)
    assert _maxdiff(ours, cv2.equalizeHist(night)) <= 6


def test_clahe_golden_night(night):
    ours = np.asarray(tpuimg.clahe(night, 2.0, 8, 8))
    assert _maxdiff(ours, clahe_ref(night, 2.0, 8, 8)) <= 1
    assert _maxdiff(ours, _png("night_clahe.png")) <= 1


def test_gaussian_golden_night(night):
    f = night.astype(np.float32) / 255
    ours = np.asarray(tpuimg.gaussian(f, 3, 2.0))
    assert _maxdiff(ours, gaussian_ref(f, 3, 2.0)) < 1e-5
    cv = cv2.GaussianBlur(f, (7, 7), 2.0, borderType=cv2.BORDER_REFLECT_101)
    assert _maxdiff(ours, cv) < 1e-5
    assert _maxdiff(_u8(ours), _png("night_gauss_r3.png")) <= 1


def test_guided_golden_night(night):
    f = night.astype(np.float32) / 255
    ours = np.asarray(tpuimg.guided_filter(f, f, 8, 1e-3))  # shrink border
    assert _maxdiff(ours, guided_filter_ref(f, f, 8, 1e-3)) < 1e-3
    assert _maxdiff(_u8(ours), _png("night_guided_r8.png")) <= 1


def test_erode_golden_night(night):
    ours = np.asarray(tpuimg.erode(night, 5))
    np.testing.assert_array_equal(ours, erode_ref(night, 5))
    se = np.ones((11, 11), np.uint8)
    np.testing.assert_array_equal(
        ours, cv2.erode(night, se, borderType=cv2.BORDER_REPLICATE))
    np.testing.assert_array_equal(ours, _png("night_erode_r5.png"))


@pytest.mark.parametrize("op,radius", [("dilate", 7), ("open", 15),
                                       ("close", 15)])
def test_morphology_night_vs_opencv(night, op, radius):
    fn, ref, cv_op = {
        "dilate": (tpuimg.dilate, dilate_ref, None),
        "open": (tpuimg.morph_open, open_ref, cv2.MORPH_OPEN),
        "close": (tpuimg.morph_close, close_ref, cv2.MORPH_CLOSE),
    }[op]
    ours = np.asarray(fn(night, radius))
    np.testing.assert_array_equal(ours, ref(night, radius))
    se = np.ones((2 * radius + 1,) * 2, np.uint8)
    cv = (cv2.dilate(night, se, borderType=cv2.BORDER_REPLICATE)
          if cv_op is None else
          cv2.morphologyEx(night, cv_op, se, borderType=cv2.BORDER_REPLICATE))
    np.testing.assert_array_equal(ours, cv)


def test_integral_golden_night(night):
    ours = np.asarray(tpuimg.integral(night))
    np.testing.assert_array_equal(ours, integral_ref(night))
    np.testing.assert_array_equal(ours, cv2.integral(night)[1:, 1:])


def test_enhance_golden_night(night):
    """The staged chain against the composed oracles (the enhance-autotest
    contract, ≤2 gray levels end to end) and the stored gallery frame."""
    from tpuimg.pipeline import enhance

    ours = np.asarray(enhance(night, impl="staged"))
    eq = clahe_ref(night, 2.0, 8, 8)
    f = eq.astype(np.float32) / np.float32(255.0)
    q = guided_filter_ref(f, gaussian_ref(f, 2, 1.5), 8, 1e-3,
                          border="reflect101")
    assert _maxdiff(ours, _u8(q)) <= 2
    assert _maxdiff(ours, _png("night_enhance.png")) <= 2
