"""Multi-device scaling: data-parallel batching + spatially-sharded single frames.

The reference is strictly single-GPU (SURVEY.md §2.2: no streams, no NCCL/MPI).
This scaling layer provides what the reference structurally hints at:

- **DP**: batch of frames sharded over a mesh ``data`` axis — each op here is
  already batch-polymorphic over leading dims, so DP is a sharding annotation
  and XLA does the rest.
- **SP (spatial)**: one frame sharded by rows over an ``sp`` axis. Stencil ops
  (gaussian, morphology via ``stencil_sharded``; the guided filter via
  ``guided_filter_sharded`` with its 2r reach) need a radius-deep halo
  exchange with neighboring devices — ``shard_map`` + ``lax.ppermute``, the
  multi-device generalization of the reference's in-kernel smem halo staging
  (gGaussShare, GaussianFilter/gaussian.cu:73-126). Scan ops (integral) need
  a cross-shard carry — the same hierarchical carry decomposition the
  reference uses across thread blocks (hIntegral, Integral/integral_d.cu:
  863-893) at device radix: local scan, exchange per-shard totals, add
  exclusive prefix.
- Histogram ops need a global reduction (``psum`` of per-shard histograms):
  ``hist_equalize_sharded`` (one 256-bin psum) and ``clahe_sharded``
  (ytiles*xtiles partial tile hists psum'd, mapping shard-local).

All five reference op families are covered; __graft_entry__.dryrun_multichip
compiles and runs the full chain on an (data, sp) mesh.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuimg.core.borders import pad_mode


def make_mesh(n_data: int, n_sp: int, devices=None) -> Mesh:
    """(data, sp) mesh over the first n_data*n_sp devices."""
    devices = devices if devices is not None else jax.devices()
    n = n_data * n_sp
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    import numpy as np

    return Mesh(np.asarray(devices[:n]).reshape(n_data, n_sp), ("data", "sp"))


def shard_batch(mesh: Mesh, batch):
    """Place a (B, H, W) batch with B sharded over the ``data`` axis."""
    return jax.device_put(batch, NamedSharding(mesh, P("data", None, None)))


def shard_rows(mesh: Mesh, img):
    """Place one (H, W) frame with H sharded over the ``sp`` axis.

    2-D only: the sharded ops partition a leading dim over the ``data``
    axis (``_spec``), so a replicated-leading-dim placement from here would
    never be accepted by them (round-2 review) — use ``shard_batch`` for
    (B, H, W) batches."""
    if img.ndim != 2:
        raise ValueError(
            f"shard_rows places a single (H, W) frame; got ndim={img.ndim} "
            f"— use shard_batch for batched inputs"
        )
    return jax.device_put(img, NamedSharding(mesh, P("sp", None)))


def _spec(ndim: int) -> P:
    """Default partitioning: leading batch dim on ``data`` (if present), rows
    on ``sp``, columns replicated."""
    if ndim == 2:
        return P("sp", None)
    return P("data", *([None] * (ndim - 3)), "sp", None)


def _halo_exchange(block, radius: int, n: int, axis_name: str, border: str):
    """Pad a row-shard with ``radius`` rows from its neighbor shards.

    Outer shards fall back to the local border policy — equivalent to padding
    the full image and then sharding, provided each shard holds ≥ radius rows
    (≥ radius+1 for reflect borders: a full-image reflect-101 pad reads rows
    1..radius, which must all live in the edge shard — and jnp.pad "reflect"
    with pad == dim silently multi-reflects rather than erroring). A thinner
    shard would need second-neighbor data and the single ppermute would
    silently corrupt the result, so both cases raise.
    """
    min_rows = radius + 1 if pad_mode(border) == "reflect" else radius
    if n > 1 and block.shape[-2] < min_rows:
        raise ValueError(
            f"row shard holds {block.shape[-2]} rows < {min_rows} "
            f"(radius {radius}, border {border!r}): halo exchange needs "
            f"every shard to cover the stencil reach (use fewer sp shards "
            f"or a smaller radius)"
        )
    pad_cfg = [(0, 0)] * (block.ndim - 2) + [(radius, radius), (0, 0)]
    local = jnp.pad(block, pad_cfg, mode=pad_mode(border))
    if n == 1:
        return local
    idx = jax.lax.axis_index(axis_name)
    up = [(i, (i + 1) % n) for i in range(n)]    # my last rows → shard i+1
    down = [(i, (i - 1) % n) for i in range(n)]  # my first rows → shard i-1
    top_halo = jax.lax.ppermute(block[..., -radius:, :], axis_name, up)
    bot_halo = jax.lax.ppermute(block[..., :radius, :], axis_name, down)
    top = jnp.where(idx == 0, local[..., :radius, :], top_halo)
    bot = jnp.where(idx == n - 1, local[..., -radius:, :], bot_halo)
    return jnp.concatenate([top, block, bot], axis=-2)


def stencil_sharded(op, radius: int, border: str, mesh: Mesh):
    """Lift a local stencil op (operating on a padded block, producing an
    unpadded block) to a row-sharded image via halo exchange.

    ``op(padded_block)`` must consume exactly ``radius`` halo rows on each
    side of the row axis.
    """
    from tpuimg.core.validate import check_radius

    check_radius(radius)  # radius=0 would make _halo_exchange slice [-0:]
    n_sp = mesh.shape["sp"]

    def run(img):
        spec = _spec(img.ndim)

        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(spec,),
            out_specs=spec,
        )
        def inner(block):
            padded = _halo_exchange(block, radius, n_sp, "sp", border)
            return op(padded)

        return inner(img)

    return run


def integral_sharded(mesh: Mesh):
    """Row-sharded integral image with cross-device carry.

    Local 2D cumsum per shard; the carry into shard k is the column-cumsum of
    all previous shards' last rows — all-gathered and prefix-summed with a
    static lower-triangular weighting (the reference's tile-carry scan,
    Integral/integral_d.cu:504-593, at device radix).
    """

    def run(img):
        from tpuimg.core.validate import DTypeError

        if jnp.issubdtype(jnp.asarray(img).dtype, jnp.floating):
            # same contract as ops.integral: astype(int32) would silently
            # truncate a [0,1) float image to zeros (round-2 review)
            raise DTypeError(
                f"integral_sharded is the uint8 -> int32 prefix sum; got "
                f"float dtype {jnp.asarray(img).dtype}"
            )
        spec = _spec(img.ndim)

        @functools.partial(jax.shard_map, mesh=mesh, in_specs=(spec,), out_specs=spec)
        def inner(block):
            local = jnp.cumsum(
                jnp.cumsum(block.astype(jnp.int32), axis=-1, dtype=jnp.int32),
                axis=-2,
                dtype=jnp.int32,
            )
            last = local[..., -1:, :]  # (..., 1, W) per-shard column totals
            all_last = jax.lax.all_gather(last, "sp", axis=-2, tiled=True)
            idx = jax.lax.axis_index("sp")
            n = jax.lax.axis_size("sp")
            shard_ids = jnp.arange(n)
            mask = (shard_ids < idx).astype(jnp.int32)[:, None]
            carry = jnp.sum(all_last * mask, axis=-2, keepdims=True)
            return local + carry

        return inner(img)

    return run


def guided_filter_sharded(mesh: Mesh, radius: int, eps: float,
                          self_guided: bool = False):
    """Row-sharded guided filter (reflect-101 fused-path semantics).

    The fused chain consumes a 2*radius halo: pass 1's windowed means of
    P, I, I*P, I*I need ``radius`` rows and pass 2's box means of a, b need
    ``radius`` more (the reference's gCalcAB + gWeightByABm reach,
    GuidedFilter/guided_filter_d.cu:421-858). One ppermute halo exchange of
    2r rows per input, then the whole chain runs shard-local.

    ``self_guided=True`` builds the P ≡ I specialization: one halo exchange
    and the 2-mean collapse; call the returned fn as ``run(I)``. The flag is
    factory-level (static) because object identity cannot be detected inside
    a jitted call — duplicated arguments become distinct tracers. Unjitted
    calls with ``p is I`` also take the fast path.
    """
    from tpuimg.core.validate import check_positive, check_radius
    from tpuimg.ops.guided import guided_ypadded

    check_radius(radius)
    check_positive(eps, "eps")  # eps=0 gives 0/0=NaN on constant windows
    n_sp = mesh.shape["sp"]

    def run(I, p=None):
        spec = _spec(I.ndim)
        if self_guided and p is not None and p is not I:
            raise ValueError(
                "guided_filter_sharded(self_guided=True) got a distinct "
                "source p — it would be silently ignored; build the op "
                "without self_guided for a separate guide/source pair"
            )
        if not self_guided and p is None:
            # a forgotten source argument must not silently degrade to the
            # self-guided filter — that produces plausible but wrong output
            raise TypeError(
                "guided_filter_sharded built without self_guided requires a "
                "source p; pass run(I, p) or build with self_guided=True"
            )
        if self_guided or p is I:

            @functools.partial(
                jax.shard_map, mesh=mesh, in_specs=(spec,), out_specs=spec)
            def inner_self(Ib):
                Ip = _halo_exchange(Ib, 2 * radius, n_sp, "sp", "reflect101")
                return guided_ypadded(Ip, Ip, radius, eps)

            return inner_self(I)

        @functools.partial(
            jax.shard_map, mesh=mesh, in_specs=(spec, spec), out_specs=spec)
        def inner(Ib, pb):
            Ip = _halo_exchange(Ib, 2 * radius, n_sp, "sp", "reflect101")
            pp = _halo_exchange(pb, 2 * radius, n_sp, "sp", "reflect101")
            return guided_ypadded(Ip, pp, radius, eps)

        return inner(I, p)

    return run


def clahe_sharded(mesh: Mesh, clip_limit: float, xtiles: int, ytiles: int):
    """Row-sharded CLAHE, exact vs the single-device op.

    Tile histograms: every shard computes its rows' contributions to each of
    the ytiles*xtiles tile histograms (including the centered reflect-101
    extension rows, which shard 0 / n-1 own the sources of), then one
    ``psum`` over ``sp`` merges them — the multi-device generalization of the
    reference's per-tile smem privatization + atomic merge
    (Histogram/image_process.cu:208-239). Clip/redistribute/CDF (tiny,
    256*T values) run replicated; the bilinear 4-LUT mapping is shard-local
    with global row coordinates.
    """
    from tpuimg.core.layout import cdiv
    from tpuimg.core.validate import check_positive, check_radius
    from tpuimg.ops.histogram import (
        _blend_to_u8, _clip_redistribute, _map_tables, _onehot_nibbles,
        _tile_coords)

    # same parameter contract as the local op (ops/histogram.py): tile
    # counts are ints >= 1, clip_limit > 0 — fail typed at factory build
    check_radius(xtiles, name="xtiles")
    check_radius(ytiles, name="ytiles")
    check_positive(clip_limit, "clip_limit")

    n_sp = mesh.shape["sp"]

    def run(img):
        from tpuimg.core.validate import check_image

        if img.ndim != 2:
            raise ValueError("clahe_sharded shards one (H, W) frame by rows")
        check_image(img, "img", dtypes=[jnp.uint8])
        h, w = img.shape
        tw, th = cdiv(w, xtiles), cdiv(h, ytiles)
        pad_left = (tw * xtiles - w) >> 1
        pad_top = (th * ytiles - h) >> 1
        pad_bot = th * ytiles - h - pad_top
        pad_right = tw * xtiles - w - pad_left
        if max(pad_top, pad_bot) + 1 > h or max(pad_left, pad_right) + 1 > w:
            # same bound AND same typed error as the single-device op
            # (ops/histogram.py raises ParamError for this condition);
            # without it the pad masks reference rows >= h, silently
            # undercounting tile histograms (round-2 review)
            from tpuimg.core.validate import ParamError

            raise ParamError(
                f"tile grid {xtiles}x{ytiles} needs more reflect padding "
                f"than the {h}x{w} image can provide"
            )
        # arbitrary H (round 4): pad rows to a shard multiple; pad rows are
        # excluded from every tile histogram by the `gy < h` weight clamp
        # below, and their mapped garbage rows are cropped after shard_map
        hs = -(-h // n_sp)  # shard_map block rows
        hpad = hs * n_sp - h
        if hpad:
            img = jnp.pad(img, ((0, hpad), (0, 0)))

        def hists_weighted(rows_block, wrow):
            """(R, Wext) u8 + (ytiles, R) int weights -> (T, 256) counts.

            ONE one-hot contraction to per-(xtile, row) 256-bin partials,
            then a tiny (ytiles, R) weighting — replaces the former
            per-y-tile masked passes, which re-contracted the full block up
            to ~2*ytiles times (round-2 review)."""
            t = rows_block.reshape(rows_block.shape[0], xtiles, tw)
            t = jnp.moveaxis(t, 1, 0)  # (xtiles, R, tw)
            oh_hi, oh_lo = _onehot_nibbles(t)
            partial = jnp.einsum("xrwa,xrwb->xrab", oh_hi, oh_lo,
                                 preferred_element_type=jnp.int32)
            hk = jnp.einsum("kr,xrab->kxab", wrow, partial,
                            preferred_element_type=jnp.int32)
            return hk.reshape(ytiles * xtiles, 256)

        @functools.partial(
            jax.shard_map, mesh=mesh, in_specs=(P("sp", None),),
            out_specs=P("sp", None),
        )
        def inner(block):
            idx = jax.lax.axis_index("sp")
            o = idx * hs  # global image row of local row 0

            # --- local x extension (reflect-101, centered) ---
            ext = jnp.concatenate(
                [jnp.flip(block[:, 1 : pad_left + 1], axis=1), block,
                 jnp.flip(block[:, w - 1 - pad_right : w - 1], axis=1)],
                axis=1)  # (hs, xtiles*tw)

            # --- per-tile row weights: how many times each LOCAL row counts
            # into each y-tile's histogram. Identity rows count once into
            # their tile; reflect-extension rows count again into the tile
            # their pad section lies in — extension row e belongs to y-tile
            # e // th, NOT always tile 0 / ytiles-1: dense tile grids on
            # short images give pad >= th (e.g. h=18, ytiles=16 → th=2,
            # pad_top=7 spans 4 tiles). All ranges are static; psum merges
            # whichever shard owns the source rows. ---
            gy = o + jnp.arange(hs)  # global rows of this block
            krange = jnp.arange(ytiles)[:, None]
            lo_img = krange * th - pad_top  # tile k's first image row
            # `gy < h` keeps bottom pad rows (H not a shard multiple) out of
            # the last tile's identity window; the reflect windows below
            # only reference rows < h by construction
            wrow = ((gy[None, :] >= lo_img)
                    & (gy[None, :] < lo_img + th)
                    & (gy[None, :] < h)).astype(jnp.int32)
            for k in range(ytiles):  # top pad: ext rows [k*th, ..) ∩ [0, pad_top)
                e_lo, e_hi = k * th, min((k + 1) * th, pad_top)
                if e_lo >= e_hi:
                    break
                # ext row e reflects image row pad_top - e
                wrow = wrow.at[k].add(
                    ((gy >= pad_top - e_hi + 1)
                     & (gy <= pad_top - e_lo)).astype(jnp.int32))
            base = pad_top + h  # bottom pad: ext rows [base, base + pad_bot)
            for k in range(ytiles):
                e_lo = max(k * th, base)
                e_hi = min((k + 1) * th, base + pad_bot)
                if e_lo >= e_hi:
                    continue
                # ext row base + j reflects image row h - 2 - j
                j_lo, j_hi = e_lo - base, e_hi - base
                wrow = wrow.at[k].add(
                    ((gy >= h - 1 - j_hi)
                     & (gy <= h - 2 - j_lo)).astype(jnp.int32))

            hists = jax.lax.psum(hists_weighted(ext, wrow), "sp")

            # --- clip + redistribute + per-tile float LUTs (replicated) ---
            limit = int(tw * th * clip_limit / 256 + 0.5)
            hists = _clip_redistribute(hists, limit)
            fr = jnp.float32(255.0 / (tw * th))
            tables = jnp.cumsum(hists, axis=-1).astype(jnp.float32) * fr

            # --- bilinear 4-LUT mapping: dynamic ty per row (global coords,
            # same f32 math as the local op), static per-column tx, four
            # per-pixel gathers from the table bank ---
            gyf = (o + jnp.arange(hs)).astype(jnp.float32)
            tyf = (gyf + jnp.float32(pad_top)) / jnp.float32(th) \
                - jnp.float32(0.5)
            ty1 = jnp.trunc(tyf).astype(jnp.int32)
            ty2 = jnp.minimum(ty1 + 1, ytiles - 1)
            ya = (tyf - ty1.astype(jnp.float32))[:, None]
            tx1, tx2, xa = _tile_coords(w, xtiles, tw, pad_left,
                                        use_recip=True)
            return _blend_to_u8(_map_tables(
                tables.reshape(-1), block, ty1[:, None], ty2[:, None],
                jnp.asarray(tx1)[None, :], jnp.asarray(tx2)[None, :], xtiles,
                jnp.asarray(xa)[None, :], ya))

        out = inner(img)
        return out[:h] if hpad else out

    return run


def enhance_sharded(mesh: Mesh, clip_limit: float = 2.0, tiles: int = 8,
                    radius: int = 2, sigma: float = 1.5, gf_radius: int = 8,
                    gf_eps: float = 1e-3):
    """Row-sharded flagship enhance chain (pipeline.enhance "staged"
    semantics): CLAHE → gaussian denoise → guided detail restore, end to end
    over the ``sp`` mesh axis.

    The tail runs as ONE shard_map region with a single halo exchange of
    depth ``2*gf_radius + radius``: gaussian_ypadded consumes ``radius``
    halo rows and leaves ``2*gf_radius`` of computed smooth pad for the
    guided chain — exact at the outer shards because symmetric kernels
    commute with the reflect-101 mirror.
    The reference has no multi-module chain at all — each demo is a separate
    executable with host round-trips between them (SURVEY.md §3).

    Arbitrary H: when H doesn't divide over ``sp``, rows are padded with the
    image's true reflect-101 extension at least ``2*gf_radius + radius``
    deep, so every kept output row reads only true-extension values (the
    edge shard's local reflect of a *padded* block diverges from the image's
    extension closer than that); the pad rows are cropped after shard_map.
    """
    from tpuimg.core.validate import check_positive, check_radius
    from tpuimg.ops.gaussian import gaussian_ypadded
    from tpuimg.ops.guided import guided_ypadded

    check_radius(radius)
    check_radius(gf_radius, name="gf_radius")
    check_positive(sigma, "sigma")
    check_positive(gf_eps, "gf_eps")
    cl = clahe_sharded(mesh, clip_limit, tiles, tiles)
    n_sp = mesh.shape["sp"]
    reach = 2 * gf_radius + radius

    def run(img):
        from tpuimg.core.validate import check_image

        img = jnp.asarray(img)
        if img.ndim != 2:
            raise ValueError("enhance_sharded shards one (H, W) frame by rows")
        check_image(img, "img", dtypes=[jnp.uint8])
        h, _ = img.shape
        eq = cl(img)  # u8 CLAHE, staged semantics (inter-stage quantization)
        f = eq.astype(jnp.float32) * jnp.float32(1.0 / 255.0)
        hpad = 0
        if h % n_sp:
            hs = -(-(h + reach) // n_sp)  # pad depth >= reach (see docstring)
            hpad = hs * n_sp - h
            if hpad > h - 1:
                raise ValueError(
                    f"enhance_sharded needs h-1 >= pad rows ({hpad}) to build "
                    f"the reflect-101 shard padding for H={h} over "
                    f"{n_sp} sp shards — use fewer shards or a shard-multiple H"
                )
            f = jnp.pad(f, ((0, hpad), (0, 0)), mode="reflect")

        @functools.partial(
            jax.shard_map, mesh=mesh, in_specs=(P("sp", None),),
            out_specs=P("sp", None),
        )
        def tail(fb):
            fp = _halo_exchange(fb, reach, n_sp, "sp", "reflect101")
            smooth = gaussian_ypadded(fp, radius, sigma)
            Ip = fp[radius : fp.shape[-2] - radius, :]
            return guided_ypadded(Ip, smooth, gf_radius, gf_eps)

        q = tail(f)
        out = jnp.clip(jnp.rint(q * 255.0), 0.0, 255.0).astype(jnp.uint8)
        return out[:h] if hpad else out

    return run


def hist_equalize_sharded(mesh: Mesh):
    """Row-sharded global HE: psum of per-shard/per-image histograms over the
    ``sp`` axis, shared LUT, local application. Batched inputs keep one
    histogram per image (the ``data`` axis is never reduced)."""
    from tpuimg.ops.histogram import _he_tables, apply_lut, bincount256

    def run(img):
        from tpuimg.core.validate import check_image

        check_image(img, "img", dtypes=[jnp.uint8])
        if img.ndim > 3:
            # inner() folds every non-leading dim into ONE histogram, which
            # would break per-frame semantics for (B1, B2, H, W) inputs
            # (round-2 review) — flatten leading batch dims first
            raise ValueError(
                f"hist_equalize_sharded takes (H, W) or (B, H, W) inputs; "
                f"got ndim={img.ndim} — flatten leading batch dims to one"
            )
        spec = _spec(img.ndim)
        per_image = img.shape[-2] * img.shape[-1]

        @functools.partial(jax.shard_map, mesh=mesh, in_specs=(spec,), out_specs=spec)
        def inner(block):
            if block.ndim == 2:
                hist = jax.lax.psum(bincount256(block), "sp")
                return apply_lut(_he_tables(hist, per_image), block)
            hists = jax.lax.psum(bincount256(block, per_leading=True), "sp")
            return jax.vmap(apply_lut)(_he_tables(hists, per_image), block)

        return inner(img)

    return run
