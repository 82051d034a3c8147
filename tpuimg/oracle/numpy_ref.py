"""Pure-NumPy oracle implementations with the reference's exact semantics.

The reference verifies every op against OpenCV by max-abs-diff (SURVEY.md §4).
For hermetic tests we reimplement the *reference's own* math (not OpenCV's
internals) in NumPy, following the cited CUDA kernels line by line in spirit:
index maps, rounding modes (`__float2int_rn` = round-half-to-even = np.rint;
float→u8 assignment = truncate), and normalization conventions. These oracles
are the ground truth the library's ops must match.
"""

from __future__ import annotations

import numpy as np

from tpuimg.core.borders import REFLECT101, REPLICATE, pad_mode, reflect101_index
from tpuimg.core.kernelgen import gaussian_kernel_1d, gaussian_kernel_2d
from tpuimg.core.layout import cdiv

# ---------------------------------------------------------------------------
# Gaussian (reference GaussianFilter/gaussian.cu — all variants compute the
# same 2D convolution with reflect-101 border; `gGaussNaive` gaussian.cu:25-46)
# ---------------------------------------------------------------------------


def gaussian_ref(img: np.ndarray, radius: int, sigma: float) -> np.ndarray:
    """2D Gaussian convolution, reflect-101 border, float64 accumulation."""
    img = np.asarray(img, dtype=np.float64)
    k = gaussian_kernel_2d(radius, sigma, dtype=np.float64)
    p = np.pad(img, radius, mode=pad_mode(REFLECT101))
    h, w = img.shape
    out = np.zeros_like(img)
    for dy in range(2 * radius + 1):
        for dx in range(2 * radius + 1):
            out += k[dy, dx] * p[dy : dy + h, dx : dx + w]
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# Integral image (reference Integral/integral_d.cu:863-893) — inclusive 2D
# prefix sum with NO leading zero row/col (Integral/main.cpp:124-125).
# ---------------------------------------------------------------------------


def integral_ref(img: np.ndarray) -> np.ndarray:
    return np.cumsum(np.cumsum(img.astype(np.int64), axis=0), axis=1).astype(np.int32)


# ---------------------------------------------------------------------------
# Histogram equalization (reference Histogram/image_process.cu:72-136,
# hist_equalization.cpp:37-77): table[v] = rint(min(255, cdf_incl[v]*256/N)).
# ---------------------------------------------------------------------------


def hist_equalize_ref(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, dtype=np.uint8)
    hist = np.bincount(img.ravel(), minlength=256)
    cdf = np.cumsum(hist)
    factor = np.float32(256.0 / img.size)  # host-side f32, hist_equalization.cpp:58
    table = np.rint(np.minimum(np.float32(255.0), cdf.astype(np.float32) * factor))
    return table.astype(np.uint8)[img]


# ---------------------------------------------------------------------------
# CLAHE (reference Histogram/image_process.cu:208-510, clahe.cpp:26-104)
# ---------------------------------------------------------------------------


def clahe_tile_geometry(h: int, w: int, xtiles: int, ytiles: int):
    """Tile dims + centered padding (clahe.cpp:28-38)."""
    tw, th = cdiv(w, xtiles), cdiv(h, ytiles)
    pad_left = (tw * xtiles - w) >> 1
    pad_top = (th * ytiles - h) >> 1
    return tw, th, pad_left, pad_top


def clahe_tile_hists_ref(img, xtiles, ytiles):
    """Per-tile histograms over the reflect-101-extended centered padding
    (gCalcTileHistsUnroll, image_process.cu:208-239)."""
    h, w = img.shape
    tw, th, pad_left, pad_top = clahe_tile_geometry(h, w, xtiles, ytiles)
    ys = reflect101_index(np.arange(th * ytiles) - pad_top, h)
    xs = reflect101_index(np.arange(tw * xtiles) - pad_left, w)
    ext = img[np.ix_(ys, xs)]  # (th*yt, tw*xt)
    tiles = ext.reshape(ytiles, th, xtiles, tw).transpose(0, 2, 1, 3)
    hists = np.zeros((ytiles * xtiles, 256), np.int64)
    flat = tiles.reshape(ytiles * xtiles, th * tw)
    for t in range(hists.shape[0]):
        hists[t] = np.bincount(flat[t], minlength=256)
    return hists


def clahe_clip_ref(hists, limit: int):
    """Clip + redistribute (gClipLimit, image_process.cu:242-268)."""
    hists = hists.copy()
    for t in range(hists.shape[0]):
        hv = hists[t]
        steal = int(np.maximum(hv - limit, 0).sum())
        hv[:] = np.minimum(hv, limit)
        bonus = steal >> 8
        residual = steal - (bonus << 8)
        hv += bonus
        if residual > 0:
            idx = (np.arange(residual) << 8) // residual
            np.add.at(hv, idx, 1)
    return hists


def clahe_tables_ref(hists, tile_pixels: int):
    """Float LUT = inclusive cdf * (255/tile_pixels) in f32
    (gCreateTable image_process.cu:271-327, fr at :499)."""
    fr = np.float32(255.0 / tile_pixels)
    cdf = np.cumsum(hists, axis=1).astype(np.float32)
    return cdf * fr


def clahe_ref(img: np.ndarray, clip_limit: float, xtiles: int, ytiles: int) -> np.ndarray:
    """Full CLAHE matching Claher::run (clahe.cpp:26-104) +
    gInterpolateMappingUnroll (image_process.cu:428-471)."""
    img = np.asarray(img, dtype=np.uint8)
    h, w = img.shape
    tw, th, pad_left, pad_top = clahe_tile_geometry(h, w, xtiles, ytiles)
    hists = clahe_tile_hists_ref(img, xtiles, ytiles)
    limit = int(tw * th * clip_limit / 256 + 0.5)  # clahe.cpp:87
    hists = clahe_clip_ref(hists, limit)
    tables = clahe_tables_ref(hists, tw * th)  # (ntiles, 256) f32

    iy = np.arange(h, dtype=np.float32)[:, None]
    ix = np.arange(w, dtype=np.float32)[None, :]
    tyf = (iy + pad_top) / np.float32(th) - np.float32(0.5)
    txf = (ix + pad_left) * np.float32(1.0 / tw) - np.float32(0.5)
    ty1 = np.trunc(tyf).astype(np.int32)  # __float2int_rz — trunc toward zero
    tx1 = np.trunc(txf).astype(np.int32)
    ty2 = np.minimum(ty1 + 1, ytiles - 1)
    tx2 = np.minimum(tx1 + 1, xtiles - 1)
    ya = (tyf - ty1).astype(np.float32)  # may be negative near top border
    xa = (txf - tx1).astype(np.float32)
    ya1, xa1 = np.float32(1.0) - ya, np.float32(1.0) - xa

    v = img.astype(np.int64)
    t11 = tables[(ty1 * xtiles + tx1), v]
    t12 = tables[(ty1 * xtiles + tx2), v]
    t21 = tables[(ty2 * xtiles + tx1), v]
    t22 = tables[(ty2 * xtiles + tx2), v]
    out = (t11 * xa1 + t12 * xa) * ya1 + (t21 * xa1 + t22 * xa) * ya
    # float → uchar assignment truncates toward zero (with device-side clamp)
    return np.clip(np.trunc(out), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Box filter + guided filter (reference GuidedFilter/)
# ---------------------------------------------------------------------------


def box_filter_ref(img: np.ndarray, radius: int, border: str = "shrink") -> np.ndarray:
    """Box mean, (2r+1)² window.

    border="shrink": window clamped to image, normalized by true area
    (gIntegralToMean, guided_filter_d.cu:241-270 — class path).
    border="reflect101": fixed 1/ksz² with mirrored halo (gCalcAB fused path,
    guided_filter_d.cu:452-465).
    """
    img = np.asarray(img, dtype=np.float64)
    h, w = img.shape[:2]
    if border == "shrink":
        ii = np.zeros((h + 1, w + 1) + img.shape[2:], np.float64)
        ii[1:, 1:] = np.cumsum(np.cumsum(img, axis=0), axis=1)
        y = np.arange(h)
        x = np.arange(w)
        top = np.maximum(0, y - radius)
        bot = np.minimum(h, y + 1 + radius)
        lef = np.maximum(0, x - radius)
        rig = np.minimum(w, x + 1 + radius)
        area = ((bot - top)[:, None] * (rig - lef)[None, :]).astype(np.float64)
        s = (
            ii[np.ix_(top, lef)]
            + ii[np.ix_(bot, rig)]
            - ii[np.ix_(top, rig)]
            - ii[np.ix_(bot, lef)]
        )
        if img.ndim == 3:
            area = area[..., None]
        return (s / area).astype(np.float32)
    elif border == REFLECT101:
        ksz = 2 * radius + 1
        pad = [(radius, radius), (radius, radius)] + [(0, 0)] * (img.ndim - 2)
        p = np.pad(img, pad, mode=pad_mode(REFLECT101))
        # separable sliding-window sums via cumsum-diff in f64 — O(1)/px
        # instead of the former (2r+1)^2 shifted adds (which dominated the
        # randomized-autotest wall clock at ~47 s per 2048^2 r=8 guided
        # oracle on this 1-core host). The summation ORDER differs from a
        # direct window sum, but in f64 that is ~1e-16 relative — far below
        # every parity tolerance this oracle backs (>= 1e-4).
        out = _win1d(_win1d(p, ksz, 0), ksz, 1)
        return (out / (ksz * ksz)).astype(np.float32)
    raise ValueError(f"unknown border {border!r}")


def _win1d(a: np.ndarray, ksz: int, axis: int) -> np.ndarray:
    """Sliding sum of every length-`ksz` window along `axis` (valid mode)."""
    pad = [(0, 0)] * a.ndim
    pad[axis] = (1, 0)
    c = np.pad(np.cumsum(a, axis=axis, dtype=np.float64), pad)
    n = a.shape[axis] - ksz + 1
    hi = [slice(None)] * a.ndim
    lo = [slice(None)] * a.ndim
    hi[axis] = slice(ksz, ksz + n)
    lo[axis] = slice(0, n)
    return c[tuple(hi)] - c[tuple(lo)]


def guided_filter_ref(
    I: np.ndarray, p: np.ndarray, radius: int, eps: float, border: str = "shrink"
) -> np.ndarray:
    """Guided filter, per-channel scalar variant (GuidedFilter::run,
    guided_filter.cpp:28-66; fused math at guided_filter_d.cu:552-560,788)."""
    I = np.asarray(I, dtype=np.float64)
    p = np.asarray(p, dtype=np.float64)
    box = lambda x: box_filter_ref(x, radius, border).astype(np.float64)
    mean_p = box(p)
    mean_I = box(I)
    mean_Ip = box(I * p)
    mean_II = box(I * I)
    a = (mean_Ip - mean_p * mean_I) / (mean_II - mean_I * mean_I + eps)
    b = mean_p - a * mean_I
    q = box(a) * I + box(b)
    return q.astype(np.float32)


# ---------------------------------------------------------------------------
# Morphology (reference Morphology/image_process.cu; replicate border
# :187-191; mode 0 = erode/min, 1 = dilate/max per fn table :11-26)
# ---------------------------------------------------------------------------


def _morph_1d(img: np.ndarray, radius: int, fn, axis: int) -> np.ndarray:
    n = img.shape[axis]
    pad = [(0, 0), (0, 0)]
    pad[axis] = (radius, radius)
    p = np.pad(img, pad, mode=pad_mode(REPLICATE))
    sl = lambda d: p[d : d + n, :] if axis == 0 else p[:, d : d + n]
    out = sl(0).copy()
    for d in range(1, 2 * radius + 1):
        out = fn(out, sl(d))
    return out


def _morph_ref(img: np.ndarray, radius: int, fn) -> np.ndarray:
    # a rect SE is exactly separable for min/max (Morphology reference
    # exploits the same identity, image_process.cu:173-299); replicate
    # padding commutes with the per-axis extreme at the edges, so two
    # 1D passes equal the (2r+1)^2 window — O(r) instead of O(r^2)
    img = np.asarray(img)
    return _morph_1d(_morph_1d(img, radius, fn, 1), radius, fn, 0)


def erode_ref(img: np.ndarray, radius: int) -> np.ndarray:
    return _morph_ref(img, radius, np.minimum)


def dilate_ref(img: np.ndarray, radius: int) -> np.ndarray:
    return _morph_ref(img, radius, np.maximum)


def open_ref(img: np.ndarray, radius: int) -> np.ndarray:
    return dilate_ref(erode_ref(img, radius), radius)


def close_ref(img: np.ndarray, radius: int) -> np.ndarray:
    return erode_ref(dilate_ref(img, radius), radius)
