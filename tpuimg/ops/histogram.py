"""Global histogram equalization + CLAHE.

Reference: Histogram/ — gCalcHistUnroll8 (image_process.cu:33-69, smem atomics),
gCalcHeTable (:72-124, Blelloch CDF + rint LUT), gMapping (:127-136), and the
CLAHE chain gCalcTileHistsUnroll → gClipLimit → gCreateTable →
gInterpolateMappingUnroll (:208-510) driven by Claher::run (clahe.cpp:26-104).

Design:
- 256-bin histograms are nibble one-hot contractions, v = 16*hi + lo:
  hist[16a+b] = Σ_p (hi_p==a)(lo_p==b), an int8 (16,P)@(P,16) product with
  int32 accumulation (exact for any size). XLA's scatter-add lowering
  funnels every pixel through atomics on the same 256 counters and measured
  slower on the H100; CLAHE's per-tile histograms spread over
  ytiles*xtiles*256 counters, where the scatter-add wins (PERF.md);
- LUT application and the CLAHE 4-corner lookup are plain per-pixel gathers
  from the (small, cache-resident) tables;
- clip/redistribute's serial residual loop (`hist[(i<<8)/residual] += 1`,
  image_process.cu:266) becomes a closed-form per-bin count.
All rounding matches the CUDA ops: `__float2int_rn` → jnp.rint (half-to-even),
`__float2int_rz` → trunc, float→u8 assignment → truncation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tpuimg.core.layout import cdiv


def _onehot_nibbles(x):
    """Split u8 values into (hi, lo) int8 nibble one-hots of shape (..., 16)."""
    xi = x.astype(jnp.int32)
    i16 = jnp.arange(16, dtype=jnp.int32)
    return (((xi >> 4)[..., None] == i16).astype(jnp.int8),
            ((xi & 15)[..., None] == i16).astype(jnp.int8))


def bincount256(x, per_leading: bool = False):
    """256-bin int32 histogram(s) of a uint8 array.

    per_leading=False reduces everything; True keeps the leading dim and
    reduces the rest (one histogram per leading index).
    """
    flat = x.reshape(x.shape[0], -1) if per_leading else x.reshape(1, -1)
    oh_hi, oh_lo = _onehot_nibbles(flat)  # (G, P, 16) each
    h = jnp.einsum("gpa,gpb->gab", oh_hi, oh_lo,
                   preferred_element_type=jnp.int32).reshape(-1, 256)
    return h if per_leading else h[0]


def apply_lut(table, img):
    """dst = table[img] (gMapping, image_process.cu:127-136); exact for any
    table dtype."""
    return jnp.asarray(table)[jnp.asarray(img).astype(jnp.int32)]


def _he_tables(hists, pixels: int):
    """table[v] = rint(min(255, cdf[v]*256/N)) per histogram (last axis)."""
    cdfs = jnp.cumsum(hists, axis=-1).astype(jnp.float32)
    factor = jnp.float32(256.0 / pixels)
    return jnp.rint(jnp.minimum(jnp.float32(255.0), cdfs * factor)
                    ).astype(jnp.uint8)


@jax.jit
def hist_equalize(img):
    """Global HE of a uint8 image: table[v] = rint(min(255, cdf[v]*256/N))
    (gCalcHeTable, image_process.cu:115-123; factor hist_equalization.cpp:58).
    Leading batch dims get one histogram/LUT per (H, W) frame.

    Note: the reference kernel undercounts the last x-block of each row band
    (in-loop ``return`` before the smem flush, image_process.cu:54-58); we
    implement the intended algorithm (KNOWN_DIVERGENCES.md §1).
    """
    from tpuimg.core.validate import check_image

    img = jnp.asarray(img)
    # uint8 only: a silent jnp.asarray(img, uint8) would turn a [0,1] float
    # image into near-zeros
    check_image(img, "img", dtypes=[jnp.uint8])
    frames = img.reshape((-1,) + img.shape[-2:])
    tables = _he_tables(bincount256(frames, per_leading=True),
                        img.shape[-2] * img.shape[-1])
    out = jax.vmap(apply_lut)(tables, frames)
    return out.reshape(img.shape)


# ---------------------------------------------------------------------------
# CLAHE
# ---------------------------------------------------------------------------


def _clip_redistribute(hists, limit: int):
    """Vectorized gClipLimit (image_process.cu:242-268).

    steal = total excess over limit; every bin gets ``steal >> 8``; the
    residual r = steal & 255 lands one count each on bins (i<<8)//r for
    i < r — counted in closed form per bin.
    """
    excess = jnp.maximum(hists - limit, 0)
    steal = jnp.sum(excess, axis=-1, keepdims=True)
    clipped = jnp.minimum(hists, limit)
    bonus = steal >> 8
    residual = steal - (bonus << 8)  # in [0, 255]
    b = jnp.arange(256, dtype=jnp.int32)
    # #{i : (i << 8) // r == b, 0 <= i < r} = max(0, hi - lo + 1)
    lo = -((-b * residual) // 256)
    hi = ((b + 1) * residual - 1) // 256
    extra = jnp.where(residual > 0, jnp.maximum(hi - lo + 1, 0), 0)
    return clipped + bonus + extra


def _bilinear_blend(t11, t12, t21, t22, xa, ya):
    """The 4-LUT bilinear lerp (gInterpolateMappingUnroll,
    image_process.cu:462-469). Single source of truth for the blend formula —
    consumed by ``clahe`` AND parallel.clahe_sharded, so a rounding change
    can never skew one against the other."""
    xa1 = jnp.float32(1.0) - xa
    ya1 = jnp.float32(1.0) - ya
    return (t11 * xa1 + t12 * xa) * ya1 + (t21 * xa1 + t22 * xa) * ya


def _blend_to_u8(out):
    """float → uchar device assignment: truncate with clamp (the CUDA
    implicit conversion in image_process.cu:469). Shared with clahe_sharded."""
    return jnp.clip(jnp.trunc(out), 0.0, 255.0).astype(jnp.uint8)


def _tile_coords(n: int, tiles: int, tsize: int, pad: int, use_recip: bool):
    """Per-pixel interpolation coordinates along one axis, computed at trace
    time in NumPy f32 exactly as the device does (y: __fdiv_rn, x:
    __frcp_rn + __fmul_rn, trunc via __float2int_rz —
    image_process.cu:437,456). Returns (t1, t2, frac) arrays of length n."""
    idx = np.arange(n, dtype=np.float32)
    if use_recip:
        tf = (idx + np.float32(pad)) * (np.float32(1.0) / np.float32(tsize)) \
            - np.float32(0.5)
    else:
        tf = (idx + np.float32(pad)) / np.float32(tsize) - np.float32(0.5)
    t1 = np.trunc(tf).astype(np.int32)
    t2 = np.minimum(t1 + 1, tiles - 1)
    return t1, t2, (tf - t1).astype(np.float32)


def _map_tables(flat_tables, v, ty1, ty2, tx1, tx2, xtiles: int, xa, ya):
    """Bilinear 4-corner mapping as four per-pixel gathers from the flat
    (T*256,) f32 table bank. ty*/tx* are int32 tile indices broadcastable
    against ``v`` (rows (R, 1), columns (1, W))."""
    v = v.astype(jnp.int32)

    def corner(ty, tx):
        return flat_tables[(ty * xtiles + tx) * 256 + v]

    return _bilinear_blend(corner(ty1, tx1), corner(ty1, tx2),
                           corner(ty2, tx1), corner(ty2, tx2), xa, ya)


def _hist_tiles(ext, ytiles: int, xtiles: int, th: int, tw: int):
    """Per-tile histograms of the (ytiles*th, xtiles*tw) extension: one
    scatter-add over ytiles*xtiles*256 counters. With that many counters the
    atomics rarely collide, and this beat the transpose + one-hot form on
    the H100 (PERF.md)."""
    ty = jnp.arange(ytiles * th, dtype=jnp.int32)[:, None] // th
    tx = jnp.arange(xtiles * tw, dtype=jnp.int32)[None, :] // tw
    idx = (ty * xtiles + tx) * 256 + ext.astype(jnp.int32)
    return jnp.bincount(idx.reshape(-1), length=ytiles * xtiles * 256
                        ).reshape(ytiles * xtiles, 256).astype(jnp.int32)


def _clahe_front(img, clip_limit: float, xtiles: int, ytiles: int):
    """Validated CLAHE front end: per-tile clipped LUTs + mapping geometry.

    Everything up to (and excluding) the bilinear 4-LUT mapping of
    Claher::run (clahe.cpp:26-104): tile geometry, reflect-101 centered
    extension, per-tile histograms, clip+redistribute, and the float LUTs.

    Returns (tables (ytiles*xtiles, 256) f32, th, tw, pad_top, pad_left).
    """
    from tpuimg.core.validate import (
        ParamError, ShapeError, check_image, check_positive, check_radius)

    img = jnp.asarray(img)
    # uint8 only — a silent jnp.asarray(img, uint8) would turn a [0,1] float
    # image into near-zeros (same contract as hist_equalize)
    check_image(img, "img", dtypes=[jnp.uint8])
    # tile counts must be ints >= 1 (0 divides by zero, floats break the
    # shift-based centered-pad math); clip <= 0 would drive the per-tile
    # limit negative and the CDF with it (the reference demo never guards
    # its argv here — we fail typed instead of producing garbage LUTs)
    check_radius(xtiles, name="xtiles")
    check_radius(ytiles, name="ytiles")
    check_positive(clip_limit, "clip_limit")
    if img.ndim != 2:
        raise ShapeError(
            f"clahe operates on a single (H, W) image, got shape "
            f"{tuple(img.shape)}; batch with jax.vmap(tpuimg.clahe)"
        )
    h, w = img.shape[-2], img.shape[-1]
    tw, th = cdiv(w, xtiles), cdiv(h, ytiles)
    pad_left = (tw * xtiles - w) >> 1
    pad_top = (th * ytiles - h) >> 1

    # --- per-tile histograms over the reflect-101 centered extension ---
    # (flip+concat of border slices; identical to the reflect-101 index map
    # since pads < image dims)
    pad_bot = th * ytiles - h - pad_top
    pad_right = tw * xtiles - w - pad_left
    if max(pad_top, pad_bot) + 1 > h or max(pad_left, pad_right) + 1 > w:
        raise ParamError(
            f"tile grid {xtiles}x{ytiles} needs more reflect padding than the "
            f"{h}x{w} image can provide (reference dLimitSize has the same "
            f"validity bound)"
        )
    ext = jnp.concatenate(
        [jnp.flip(img[1 : pad_top + 1, :], axis=0), img,
         jnp.flip(img[h - 1 - pad_bot : h - 1, :], axis=0)], axis=0)
    ext = jnp.concatenate(
        [jnp.flip(ext[:, 1 : pad_left + 1], axis=1), ext,
         jnp.flip(ext[:, w - 1 - pad_right : w - 1], axis=1)], axis=1)
    hists = _hist_tiles(ext, ytiles, xtiles, th, tw)

    # --- clip limit (clahe.cpp:87) + redistribute ---
    limit = int(tw * th * clip_limit / 256 + 0.5)
    hists = _clip_redistribute(hists, limit)

    # --- float LUTs: cdf * 255/tile_pixels (gCreateTable) ---
    fr = jnp.float32(255.0 / (tw * th))
    tables = jnp.cumsum(hists, axis=-1).astype(jnp.float32) * fr  # (T, 256)
    return tables, th, tw, pad_top, pad_left


@jax.jit(static_argnames=("clip_limit", "xtiles", "ytiles", "_out_f32"))
def clahe(img, clip_limit: float = 1.0, xtiles: int = 8, ytiles: int = 8,
          _out_f32: bool = False):
    """CLAHE of a uint8 (H, W) image, matching Claher::run exactly
    (defaults from the demo, Histogram/main.cpp:80-82).

    ``_out_f32`` (internal, for pipeline fusion): emit the raw bilinear
    blend in [0, 255] as float32, skipping the final u8 truncation — the
    enhance pipeline feeds the next stage at full precision instead of
    round-tripping through uint8 (truncating the blend reproduces the u8
    output bit-for-bit)."""
    img = jnp.asarray(img)
    tables, th, tw, pad_top, pad_left = _clahe_front(
        img, clip_limit, xtiles, ytiles)
    h, w = img.shape
    ty1, ty2, ya = _tile_coords(h, ytiles, th, pad_top, use_recip=False)
    tx1, tx2, xa = _tile_coords(w, xtiles, tw, pad_left, use_recip=True)
    blend = _map_tables(
        tables.reshape(-1), img,
        jnp.asarray(ty1)[:, None], jnp.asarray(ty2)[:, None],
        jnp.asarray(tx1)[None, :], jnp.asarray(tx2)[None, :], xtiles,
        jnp.asarray(xa)[None, :], jnp.asarray(ya)[:, None])
    if _out_f32:
        return blend
    return _blend_to_u8(blend)
