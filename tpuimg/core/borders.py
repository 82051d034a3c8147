"""Border policies.

The reference uses two border conventions (SURVEY.md §1):

- **reflect101** (`reflectBorder(x, sz) = -x if x < 0 else 2*sz - 2 - x if x >= sz
  else x`, reference `GaussianFilter/gaussian.h:101-104`): used by Gaussian,
  GuidedFilter's fused path, and CLAHE tile histograms. Equivalent to
  ``np.pad(mode="reflect")`` / OpenCV ``BORDER_DEFAULT``.
- **replicate** (clamp, reference `Morphology/image_process.cu:187-191`): used by
  Morphology, matching OpenCV's morphology default. Equivalent to
  ``np.pad(mode="edge")``.
- **shrink-window**: GuidedFilter's class path does not pad at all; box windows are
  clamped to the image and normalized by the true window area
  (`GuidedFilter/guided_filter_d.cu:241-270`). Handled in ops/guided.py.

All index math here is pure and usable from NumPy and jnp.
"""

from __future__ import annotations

REFLECT101 = "reflect101"
REPLICATE = "replicate"
SHRINK = "shrink"

_NUMPY_PAD_MODE = {REFLECT101: "reflect", REPLICATE: "edge"}


def reflect101_index(x, size: int):
    """Mirror-without-repeat index map: valid for -size < x < 2*size - 1.

    Matches reference ``reflectBorder`` (`GaussianFilter/gaussian.h:101-104`) and
    ``dLimitSize`` (`Histogram/image_process.cu:171-174`).
    Works on ints or integer arrays (NumPy / jnp).
    """
    x = abs(x)
    over = x - (size - 1)
    return x - 2 * over * (over > 0)


def replicate_index(x, size: int):
    """Clamp index map (reference `Morphology/image_process.cu:187-191`)."""
    lo = x * (x > 0)
    over = lo - (size - 1)
    return lo - over * (over > 0)


def pad_mode(border: str) -> str:
    """np.pad / jnp.pad mode string for a border policy."""
    try:
        return _NUMPY_PAD_MODE[border]
    except KeyError:
        from tpuimg.core.validate import ParamError

        raise ParamError(
            f"border must be one of {sorted(_NUMPY_PAD_MODE)}, got {border!r}"
        ) from None


def pad2d(xp, img, radius: int, border: str):
    """Pad the trailing two spatial dims of ``img`` by ``radius`` on each side.

    ``xp`` is the array namespace (numpy or jax.numpy). Leading batch/channel
    dims are left unpadded.
    """
    if radius == 0:
        return img
    pad = [(0, 0)] * (img.ndim - 2) + [(radius, radius), (radius, radius)]
    return xp.pad(img, pad, mode=pad_mode(border))
