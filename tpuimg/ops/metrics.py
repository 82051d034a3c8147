"""On-device comparison metrics.

Analog of the reference's device-side verification reduction
(gCmpMaxAbsDiff, Integral/integral_d.cu:811-852): compare two arrays on
device and fetch only the scalar — avoids pulling full frames back to the
host.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _absdiff(a, b):
    """Exact |a - b|: integer inputs stay in integer arithmetic (a float32
    detour would collapse differences between values above 2^24 — integral
    images reach ~1e9 where f32 spacing is 64+)."""
    if jnp.issubdtype(a.dtype, jnp.integer) and jnp.issubdtype(b.dtype, jnp.integer):
        ai = a.astype(jnp.int32)
        bi = b.astype(jnp.int32)
        return jnp.where(ai >= bi, ai - bi, bi - ai)
    return jnp.abs(a.astype(jnp.float32) - b.astype(jnp.float32))


@jax.jit
def max_abs_diff(a, b):
    """Scalar max |a - b| computed on device; exact for int32-range ints."""
    return jnp.max(_absdiff(a, b))


@jax.jit
def max_abs_diff_loc(a, b):
    """(maxdiff, y, x) — the reference's morphology demo also prints the
    location of the max difference (Morphology/main.cpp:103)."""
    d = _absdiff(a, b)
    flat = jnp.argmax(d.reshape(-1))
    w = d.shape[-1]
    return d.reshape(-1)[flat], flat // w, flat % w
