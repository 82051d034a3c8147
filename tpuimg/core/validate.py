"""Typed parameter/shape validation.

The reference fails hard at runtime via CHECK/exit(-1) on CUDA errors
(Histogram/cuda_utils.h:7-36) and silently misbehaves on bad geometry; the
library raises typed Python exceptions at trace time instead (SURVEY.md §5
"failure detection"). All checks run on static shape/dtype info, so they are
free under jit.
"""

from __future__ import annotations

import numbers

import jax.numpy as jnp
import numpy as _np


class TpuImgError(ValueError):
    """Base class for tpuimg validation errors."""


class ShapeError(TpuImgError):
    pass


class DTypeError(TpuImgError):
    pass


class ParamError(TpuImgError):
    pass


def check_image(x, name: str = "img", min_ndim: int = 2, dtypes=None):
    if x.ndim < min_ndim:
        raise ShapeError(
            f"{name} must have at least {min_ndim} dims (..., H, W); "
            f"got shape {tuple(x.shape)}"
        )
    h, w = x.shape[-2], x.shape[-1]
    if h < 1 or w < 1:
        raise ShapeError(f"{name} has empty spatial dims: {tuple(x.shape)}")
    if dtypes is not None and not any(x.dtype == jnp.dtype(d) for d in dtypes):
        raise DTypeError(
            f"{name} dtype must be one of {[str(jnp.dtype(d)) for d in dtypes]}, "
            f"got {x.dtype}"
        )
    return h, w


def check_radius(radius: int, lo: int = 1, name: str = "radius"):
    # bool is an int subclass (True would pass as radius 1); NumPy integer
    # scalars (np.int64 from configs/sweeps) are valid radii
    if (isinstance(radius, bool) or not isinstance(radius, (int, _np.integer))
            or radius < lo):
        raise ParamError(f"{name} must be an int >= {lo}, got {radius!r}")


def check_positive(value, name: str):
    # `not (value > 0)` (rather than `value <= 0`) so NaN — for which every
    # comparison is False — fails typed instead of crashing downstream with
    # an untyped float->int error (round-3 advisor finding)
    if not isinstance(value, numbers.Real) or not (value > 0):
        raise ParamError(f"{name} must be positive, got {value!r}")


def check_impl(impl: str, allowed, name: str = "impl"):
    """Reject misspelled implementation selectors: a dispatch of the form
    'if impl == "a": ... else: ...' would silently run the wrong branch."""
    if impl not in allowed:
        raise ParamError(f"{name} must be one of {allowed}, got {impl!r}")
