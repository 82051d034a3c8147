"""Integral image (inclusive 2D prefix sum), uint8 → int32.

Reference: Integral/integral_d.cu — two 4-kernel CUDA pipelines (tile scans →
Blelloch scans of tile carries → broadcast, hIntegral :863-893). Output
convention: NO leading zero row/col (Integral/main.cpp:124-125); must be
bit-exact (res.log: 3000/3000 zero-diff runs).

Design: two ``jnp.cumsum`` passes in int32, which XLA lowers to its own
parallel scans — exact for any integer input whose sums fit int32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def integral(img):
    """Inclusive 2D prefix sum over the trailing two dims; int32 result."""
    from tpuimg.core.validate import DTypeError, check_image

    check_image(img, "img")
    img = jnp.asarray(img)
    if jnp.issubdtype(img.dtype, jnp.floating):
        raise DTypeError(
            f"integral is the reference's uint8 -> int32 prefix sum "
            f"(Integral/integral_d.h:6); got float dtype {img.dtype} — "
            f"use jnp.cumsum directly for float integrals"
        )
    x = img.astype(jnp.int32)
    return jnp.cumsum(jnp.cumsum(x, axis=-1, dtype=jnp.int32), axis=-2,
                      dtype=jnp.int32)
