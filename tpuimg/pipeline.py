"""Flagship pipeline: the whole-frame enhancement chain.

The reference's demos each run one op on one frame (SURVEY.md §3); production
use chains them. Here the chain compiles into one XLA program — every
intermediate stays on device (the reference needs a host round-trip and
separate kernel launches between its modules).

``enhance``: u8 frame → CLAHE (local contrast) → Gaussian denoise → guided
filter (edge-preserving detail restore) → u8 frame.

impl="staged" composes the public ops exactly (CLAHE output quantized to u8
between stages, like a user chaining the reference executables). The default
"fused" path removes the inter-stage u8 round-trip: CLAHE emits its raw f32
blend (ops/histogram.py ``_out_f32``), which feeds the gaussian + guided tail
directly — within 1 u8 step of "staged" by construction (the blend is within
1 of its truncation, and the downstream chain is an average-of-averages that
cannot amplify a bounded perturbation).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpuimg.ops.gaussian import gaussian
from tpuimg.ops.guided import guided_filter
from tpuimg.ops.histogram import clahe


@jax.jit(static_argnames=("clip_limit", "tiles", "radius", "sigma",
                          "gf_radius", "gf_eps", "impl"))
def enhance(
    img,
    clip_limit: float = 2.0,
    tiles: int = 8,
    radius: int = 2,
    sigma: float = 1.5,
    gf_radius: int = 8,
    gf_eps: float = 1e-3,
    impl: str = "fused",
):
    """Contrast-enhance + denoise a uint8 (H, W) frame, edges preserved.

    Input validation (uint8-only, typed error on floats) happens in the
    first stage — clahe checks the same array immediately."""
    from tpuimg.core.validate import check_impl

    check_impl(impl, allowed=("fused", "staged"))
    img = jnp.asarray(img)
    if impl == "staged":
        eq = clahe(img, clip_limit, tiles, tiles)
        f = eq.astype(jnp.float32) * jnp.float32(1.0 / 255.0)
    else:
        blend = clahe(img, clip_limit, tiles, tiles, _out_f32=True)
        f = blend * jnp.float32(1.0 / 255.0)
    smooth = gaussian(f, radius, sigma)
    # fused-path border semantics (reflect101 + 1/ksz^2) — the reference's
    # own 4K guided demo
    out = guided_filter(f, smooth, gf_radius, gf_eps, border="reflect101")
    return jnp.clip(jnp.rint(out * 255.0), 0.0, 255.0).astype(jnp.uint8)
