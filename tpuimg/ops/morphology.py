"""Grayscale morphology: erode/dilate/open/close, square SE, replicate border.

Reference: Morphology/ — radius-adaptive ladder (hMorphology,
image_process.cu:465-516 + morphology.cpp:25-60):
- r ≤ 6: fused separable min/max rolling strip (gMorphSplit :173-299);
- 7 ≤ r ≤ 20: van Herk row/col with smem prefix/suffix extremes (:302-423);
- r > 20: 6-kernel Gil-Werman pipeline with transposes (:31-170).
mode 0 = erode (min), 1 = dilate (max) per the device fn table (:11-26).

Design: separable per-axis extremes, two rungs — a direct (2r+1)-term
shift-reduce that XLA fuses into one pass per axis, and segmented
``lax.cummax/cummin`` van Herk from ``_VANHERK_MIN_RADIUS`` up.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpuimg.core.borders import REPLICATE, pad_mode
from tpuimg.core.layout import round_up

# Up to r=40 the (2r+1)-term shift-reduce beat the O(1)-per-pixel van Herk
# scan at every radius swept on the H100; at r=48 it fell off an XLA fusion
# cliff (34x slower), so larger radii take the flat-cost scan (PERF.md).
_VANHERK_MIN_RADIUS = 41


def _shift_reduce_axis(x, radius: int, axis: int, fn):
    """Direct separable extreme: fn over 2r+1 shifted slices (axis pre-padded)."""
    n = x.shape[axis] - 2 * radius
    acc = jax.lax.slice_in_dim(x, 0, n, axis=axis)
    for off in range(1, 2 * radius + 1):
        acc = fn(acc, jax.lax.slice_in_dim(x, off, off + n, axis=axis))
    return acc


def _van_herk_axis(x, radius: int, axis: int, fn, cumfn):
    """van Herk/Gil-Werman along ``axis`` (axis pre-padded by radius).

    result[i] = fn(suffix[i], prefix[i + ksz - 1]) where prefix/suffix are
    forward/backward running extremes within ksz-aligned segments — the
    reference's mset1/mset2 decomposition (gCalcMinSet/gCalcMaxSet,
    image_process.cu:31-100) with reshape+cumscan instead of per-block loops.
    """
    ksz = 2 * radius + 1
    n = x.shape[axis] - 2 * radius  # output length
    L = x.shape[axis]
    Lp = round_up(L, ksz)
    if Lp != L:
        pad = [(0, 0)] * x.ndim
        pad[axis] = (0, Lp - L)
        x = jnp.pad(x, pad, mode=pad_mode(REPLICATE))
    # segments of length ksz on ``axis``
    new_shape = x.shape[:axis] + (Lp // ksz, ksz) + x.shape[axis + 1 :]
    seg = x.reshape(new_shape)
    sax = axis + 1
    prefix = cumfn(seg, axis=sax)
    suffix = jnp.flip(cumfn(jnp.flip(seg, axis=sax), axis=sax), axis=sax)
    prefix = prefix.reshape(x.shape)
    suffix = suffix.reshape(x.shape)
    s = jax.lax.slice_in_dim(suffix, 0, n, axis=axis)
    p = jax.lax.slice_in_dim(prefix, ksz - 1, ksz - 1 + n, axis=axis)
    return fn(s, p)


def _extreme_2d(x, radius: int, mode: int, rows_padded: bool):
    """Separable (2r+1)² extreme of ``x`` under the replicate border; the row
    axis is already padded by ``radius`` when ``rows_padded``."""
    fn = jnp.minimum if mode == 0 else jnp.maximum
    cumfn = jax.lax.cummin if mode == 0 else jax.lax.cummax
    pad = [(0, 0)] * (x.ndim - 2)
    pad += [(0, 0) if rows_padded else (radius, radius), (radius, radius)]
    x = jnp.pad(x, pad, mode=pad_mode(REPLICATE))
    axis_fn = (
        _shift_reduce_axis
        if radius < _VANHERK_MIN_RADIUS
        else functools.partial(_van_herk_axis, cumfn=cumfn)
    )
    x = axis_fn(x, radius, x.ndim - 1, fn)
    return axis_fn(x, radius, x.ndim - 2, fn)


def _morph(img, radius: int, mode: int):
    from tpuimg.core.validate import check_image, check_radius

    check_radius(radius)
    check_image(img, "img", dtypes=[jnp.uint8, jnp.int32, jnp.float32])
    return _extreme_2d(jnp.asarray(img), radius, mode, rows_padded=False)


def morph_ypadded(p, radius: int, mode: int):
    """Erode/dilate a block already padded by ``radius`` rows on the row axis
    (halo rows); x is handled locally. Used by parallel.stencil_sharded."""
    return _extreme_2d(p, radius, mode, rows_padded=True)


@jax.jit(static_argnames=("radius",))
def erode(img, radius: int):
    """Min over a (2r+1)² square SE, replicate border (mode 0)."""
    return _morph(img, radius, 0)


@jax.jit(static_argnames=("radius",))
def dilate(img, radius: int):
    """Max over a (2r+1)² square SE, replicate border (mode 1)."""
    return _morph(img, radius, 1)


@jax.jit(static_argnames=("radius",))
def morph_open(img, radius: int):
    """Erode then dilate (square SE, replicate border)."""
    return _morph(_morph(img, radius, 0), radius, 1)


@jax.jit(static_argnames=("radius",))
def morph_close(img, radius: int):
    """Dilate then erode (square SE, replicate border)."""
    return _morph(_morph(img, radius, 1), radius, 0)
