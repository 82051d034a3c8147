"""Box filter + guided filter (He et al., per-channel scalar variant).

Reference: GuidedFilter/ — two implementations:
- class path (GuidedFilter::run, guided_filter.cpp:28-66): 6 box filters via
  row/col Blelloch scans to an integral image (gScanLongRow/Col,
  guided_filter_d.cu:10-238) + 4-corner window mean with shrink-to-image
  normalization (gIntegralToMean :241-270), then a/b/q elementwise chain.
- fused small-radius path (hGuidedFilter :1047-1093): gCalcAB computes the four
  windowed means of P, I, I*P, I*I in one rolling-strip kernel with reflect-101
  border and fixed 1/ksz² normalization (:421-669), gWeightByABm box-sums A,B
  and forms q = (ΣA·I + ΣB)/ksz² (:672-858).

Design: windowed sums along an axis are direct shifted adds (small radii)
or cumsum differences (larger radii), one pass per axis; XLA fuses the
elementwise a/b/q chain around them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpuimg.core.borders import REFLECT101, SHRINK, pad_mode


# up to this radius, direct shifted adds (which XLA fuses into one pass)
# beat the cumsum-difference form at every radius swept on the H100; r=10
# and r=12 lose to it (PERF.md)
_DIRECT_MAX_RADIUS = 9


def _window_sum(x, radius: int, axis: int, border: str | None):
    """Sliding sum of width 2r+1 along ``axis`` with the given border policy
    (``border=None``: the axis is already padded by ``radius`` on each side).

    Small radii: direct shifted adds (one fused pass). Larger: cumsum
    difference s[i] = c[i + 2r + 1] - c[i] — O(1) work per pixel.
    """
    ksz = 2 * radius + 1
    if border is None:
        n = x.shape[axis] - 2 * radius
        xp = x
    else:
        n = x.shape[axis]
        pad = [(0, 0)] * x.ndim
        pad[axis] = (radius, radius)
        xp = jnp.pad(x, pad, mode=pad_mode(border))
    if radius <= _DIRECT_MAX_RADIUS:
        acc = jax.lax.slice_in_dim(xp, 0, n, axis=axis)
        for k in range(1, ksz):
            acc = acc + jax.lax.slice_in_dim(xp, k, k + n, axis=axis)
        return acc
    c = jnp.cumsum(xp, axis=axis, dtype=x.dtype)
    zpad = [(0, 0)] * x.ndim
    zpad[axis] = (1, 0)
    c = jnp.pad(c, zpad)
    hi = jax.lax.slice_in_dim(c, ksz, ksz + n, axis=axis)
    lo = jax.lax.slice_in_dim(c, 0, n, axis=axis)
    return hi - lo


def _box_shrink(x, radius: int):
    """Shrink-window box mean (gIntegralToMean semantics): window clamped to
    the image, normalized by true area."""
    h, w = x.shape[-2], x.shape[-1]
    # Sum with zero padding (constant), then divide by the true window area.
    pad = [(0, 0)] * x.ndim
    pad[-2] = pad[-1] = (radius, radius)
    xp = jnp.pad(x, pad)  # zeros
    s = _window_sum_zero(xp, radius, h, w)
    cy = _axis_counts(h, radius)
    cx = _axis_counts(w, radius)
    area = (cy[:, None] * cx[None, :]).astype(x.dtype)
    return s / area


def _window_sum_zero(xp, radius: int, h: int, w: int):
    """Windowed sum over a zero-padded array, cropped back to (h, w)."""
    c = jnp.cumsum(xp, axis=-1, dtype=xp.dtype)
    zpad = [(0, 0)] * xp.ndim
    zpad[-1] = (1, 0)
    c = jnp.pad(c, zpad)
    ksz = 2 * radius + 1
    rows = jax.lax.slice_in_dim(c, ksz, ksz + w, axis=-1) - jax.lax.slice_in_dim(
        c, 0, w, axis=-1
    )
    c2 = jnp.cumsum(rows, axis=-2, dtype=xp.dtype)
    zpad = [(0, 0)] * xp.ndim
    zpad[-2] = (1, 0)
    c2 = jnp.pad(c2, zpad)
    return jax.lax.slice_in_dim(c2, ksz, ksz + h, axis=-2) - jax.lax.slice_in_dim(
        c2, 0, h, axis=-2
    )


def _axis_counts(n: int, radius: int):
    idx = jnp.arange(n)
    lo = jnp.maximum(0, idx - radius)
    hi = jnp.minimum(n, idx + 1 + radius)
    return hi - lo


def guided_ypadded(Ipad, ppad, radius: int, eps: float):
    """Fused-path guided filter on blocks already padded by ``2*radius`` rows
    on the row axis (halo rows from neighbor shards or the border policy);
    x is padded locally with reflect-101. Returns the unpadded rows.

    Used by parallel.guided_filter_sharded — the multi-device form of the
    reference's fused chain (gCalcAB + gWeightByABm,
    GuidedFilter/guided_filter_d.cu:421-858): pass 1 consumes ``radius`` halo
    rows, pass 2 consumes ``radius`` more.
    """
    r = radius
    ksz = 2 * r + 1
    coef = jnp.float32(1.0 / (ksz * ksz))
    self_guided = ppad is Ipad  # same collapse as guided_filter (P ≡ I)
    pad = [(0, 0)] * (Ipad.ndim - 1) + [(2 * r, 2 * r)]
    I2 = jnp.pad(jnp.asarray(Ipad, jnp.float32), pad, mode=pad_mode(REFLECT101))
    p2 = I2 if self_guided else jnp.pad(
        jnp.asarray(ppad, jnp.float32), pad, mode=pad_mode(REFLECT101))

    def box(x):  # consumes r prepadded taps per side on both trailing axes
        s = _window_sum(x, r, x.ndim - 1, None)
        return _window_sum(s, r, x.ndim - 2, None) * coef

    mean_I, mean_II = box(I2), box(I2 * I2)
    mean_p = mean_I if self_guided else box(p2)
    mean_Ip = mean_II if self_guided else box(I2 * p2)
    a = (mean_Ip - mean_p * mean_I) / (
        mean_II - mean_I * mean_I + jnp.float32(eps))
    b = mean_p - a * mean_I
    Ic = I2[..., 2 * r : I2.shape[-2] - 2 * r, 2 * r : I2.shape[-1] - 2 * r]
    return box(a) * Ic + box(b)


def box_filter_ypadded(p, radius: int):
    """Box mean (reflect-101, 1/ksz²) of a block already padded by
    ``radius`` rows per side (halo rows from a neighbor shard or the border
    policy); x is handled locally. Entry point for
    ``parallel.stencil_sharded`` — the sharded form of ``box_filter``."""
    p = jnp.asarray(p, jnp.float32)
    ksz = 2 * radius + 1
    rows = _window_sum(p, radius, p.ndim - 1, REFLECT101)
    s = _window_sum(rows, radius, p.ndim - 2, None)
    return s * jnp.float32(1.0 / (ksz * ksz))


@jax.jit(static_argnames=("radius", "border"))
def box_filter(x, radius: int, border: str = SHRINK):
    """Box mean over a (2r+1)² window of a float32 (..., H, W) image.

    border="shrink": reference class-path semantics (gIntegralToMean).
    border="reflect101": fused-path semantics (fixed 1/ksz², mirrored halo).
    """
    from tpuimg.core.validate import check_image, check_radius

    check_radius(radius)
    check_image(x, "x", dtypes=[jnp.float32, jnp.float64, jnp.uint8])
    x = jnp.asarray(x, jnp.float32)
    if border == SHRINK:
        return _box_shrink(x, radius)
    ksz = 2 * radius + 1
    rows = _window_sum(x, radius, x.ndim - 1, border)
    s = _window_sum(rows, radius, x.ndim - 2, border)
    return s * jnp.float32(1.0 / (ksz * ksz))


def guided_filter(I, p, radius: int, eps: float, border: str = SHRINK):
    """Guided filter q = mean(a)·I + mean(b) with a/b from per-channel
    variance (gCalcA math, guided_filter_d.cu:306-346).

    border="shrink": the reference's class path (shrink-window means);
    border="reflect101": its fused small-radius path (hGuidedFilter,
    guided_filter_d.cu:1047-1093: reflect-101 halo, fixed 1/ksz²).

    Passing the same array as both I and p (self-guided edge-preserving
    smoothing) collapses the four windowed means to two (P ≡ I ⇒
    mean_p ≡ mean_I, mean_Ip ≡ mean_II) — bitwise-identical output with
    fewer passes. Detected by object identity here, outside the jit
    boundary (inside a trace the duplicated argument becomes two distinct
    tracers).
    """
    return _guided_filter_impl(I, p, radius=radius, eps=eps, border=border,
                               self_guided=p is I)


@jax.jit(static_argnames=("radius", "eps", "border", "self_guided"))
def _guided_filter_impl(I, p, radius: int, eps: float, border: str,
                        self_guided: bool):
    from tpuimg.core.validate import (
        ShapeError, check_image, check_positive, check_radius)

    check_radius(radius)
    check_positive(eps, "eps")  # eps=0 gives 0/0=NaN on constant windows
    check_image(I, "I", dtypes=[jnp.float32, jnp.float64, jnp.uint8])
    check_image(p, "p", dtypes=[jnp.float32, jnp.float64, jnp.uint8])
    if p.ndim not in (I.ndim, I.ndim + 1) or p.shape[-2:] != I.shape[-2:]:
        raise ShapeError(
            f"guide I {tuple(I.shape)} and source p {tuple(p.shape)} must "
            f"share spatial dims (p may add one leading channel dim)"
        )
    I = jnp.asarray(I, jnp.float32)
    p = I if self_guided else jnp.asarray(p, jnp.float32)
    if p.ndim == I.ndim + 1:
        # C-channel source with a shared (e.g. gray) guide — the reference's
        # CN1 kernels (gCalcACN1/gCalcBCN1/gLinearTransformCN1,
        # guided_filter_d.cu:326-412): per-channel scalar filter, guide fixed
        return jax.vmap(
            lambda pc: guided_filter(I, pc, radius, eps, border)
        )(p)
    box = functools.partial(box_filter, radius=radius, border=border)
    mean_I = box(I)
    mean_II = box(I * I)
    mean_p = mean_I if self_guided else box(p)
    mean_Ip = mean_II if self_guided else box(I * p)
    a = (mean_Ip - mean_p * mean_I) / (mean_II - mean_I * mean_I + jnp.float32(eps))
    b = mean_p - a * mean_I
    return box(a) * I + box(b)
