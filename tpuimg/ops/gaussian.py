"""Separable Gaussian blur.

Reference: GaussianFilter/gaussian.cu — a ladder of 5 CUDA kernels
(naive/const/share/split/optim, gaussian.cu:25-306) all computing a 2D
convolution with reflect-101 border and weights from
``cv::getGaussianKernel`` (gaussian.cu:443-446).

Design: the separable symmetric form ``k[i]*(x[-i] + x[+i])`` (the
`gGaussSplit` trick, gaussian.cu:129-178) expressed as shift-and-add over a
reflect-padded image; XLA fuses each axis pass into one elementwise kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tpuimg.core.borders import REFLECT101, pad_mode
from tpuimg.core.kernelgen import gaussian_kernel_1d


def _sep_pass(img, weights, axis: int):
    """One separable pass along ``axis`` (already padded by radius there)."""
    radius = (len(weights) - 1) // 2
    n = img.shape[axis] - 2 * radius

    def sl(off):
        return jax.lax.slice_in_dim(img, off, off + n, axis=axis)

    center = sl(radius)
    acc = weights[radius] * center
    for i in range(1, radius + 1):
        # symmetric-kernel trick (gaussian.cu:160-168): k[i]*(left + right)
        acc = acc + weights[radius - i] * (sl(radius - i) + sl(radius + i))
    return acc


def _weights(radius: int, sigma: float):
    return [float(v) for v in
            np.asarray(gaussian_kernel_1d(2 * radius + 1, sigma))]


def gaussian_ypadded(p, radius: int, sigma: float):
    """Gaussian blur of a block already padded by ``radius`` rows on the row
    axis (halo rows from a neighbor shard or border policy); x is handled
    locally. Used by parallel.stencil_sharded."""
    w = _weights(radius, sigma)
    pad = [(0, 0)] * (p.ndim - 1) + [(radius, radius)]
    p = jnp.pad(p, pad, mode=pad_mode(REFLECT101))
    rows = _sep_pass(p, w, axis=p.ndim - 1)
    return _sep_pass(rows, w, axis=p.ndim - 2)


@jax.jit(static_argnames=("radius", "sigma"))
def gaussian(img, radius: int, sigma: float):
    """Gaussian blur of a float image (..., H, W), reflect-101 border;
    float32 result. uint8 input is accepted and promoted (blur of the raw
    0..255 values) — the reference instead pre-scales u8 images by 1/255 on
    the host (gaussian.cu:436), which callers can do with ``img / 255``.

    Matches reference output of every kernel in the gaussian.cu ladder.
    """
    from tpuimg.core.validate import check_image, check_radius

    check_radius(radius)
    # same accepted set as guided_filter: floats, plus u8 promoted; anything
    # else (bool masks, i32 integral images passed by mistake, complex) is
    # rejected rather than silently blurred
    check_image(img, "img", dtypes=[jnp.float32, jnp.float64, jnp.uint8])
    img = jnp.asarray(img, jnp.float32)
    w = _weights(radius, sigma)
    pad = [(0, 0)] * (img.ndim - 2) + [(radius, radius), (radius, radius)]
    p = jnp.pad(img, pad, mode=pad_mode(REFLECT101))
    rows = _sep_pass(p, w, axis=img.ndim - 1)  # horizontal, rows still padded
    return _sep_pass(rows, w, axis=img.ndim - 2)
