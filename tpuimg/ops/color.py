"""On-device color conversions (RGB/BGR ↔ CIE L*a*b*, RGB ↔ gray).

The reference keeps color handling on the host in OpenCV — BGR→Lab split,
process L on the GPU, merge back (Histogram/main.cpp:99-117,159-168;
Morphology/main.cpp:196-221) — because its kernels are single-channel. Here
the conversion is just fused elementwise math, so the whole color pipeline
stays on device. Formulas match OpenCV's 8-bit Lab (D65, sRGB linearization,
L*255/100 and a,b+128 quantization; verified ≤1 step vs cv2.cvtColor).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# RGB(linear) → XYZ, D65 (OpenCV's matrix)
_RGB2XYZ = [
    [0.412453, 0.357580, 0.180423],
    [0.212671, 0.715160, 0.072169],
    [0.019334, 0.119193, 0.950227],
]
_XYZ2RGB = [
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875992, 0.041556],
    [0.055648, -0.204043, 1.057311],
]
_WHITE = (0.950456, 1.0, 1.088754)
_EPS = 0.008856  # (6/29)^3
_KAPPA = 903.3


def _srgb_to_linear(x):
    return jnp.where(x > 0.04045, ((x + 0.055) / 1.055) ** 2.4, x / 12.92)


def _linear_to_srgb(x):
    x = jnp.maximum(x, 0.0)
    return jnp.where(x > 0.0031308, 1.055 * x ** (1.0 / 2.4) - 0.055, 12.92 * x)


@jax.jit
def rgb_to_lab(rgb):
    """uint8 (..., 3) RGB → uint8 (..., 3) Lab with OpenCV's 8-bit scaling."""
    x = _srgb_to_linear(rgb.astype(jnp.float32) * jnp.float32(1 / 255.0))
    M = jnp.asarray(_RGB2XYZ, jnp.float32)
    # precision="highest": a default-precision f32 product may run in TF32
    xyz = jnp.einsum("...c,dc->...d", x, M, precision="highest") \
        / jnp.asarray(_WHITE, jnp.float32)
    f = jnp.where(xyz > _EPS, jnp.cbrt(xyz), 7.787 * xyz + jnp.float32(16.0 / 116.0))
    y = xyz[..., 1]
    L = jnp.where(y > _EPS, 116.0 * f[..., 1] - 16.0, _KAPPA * y)
    a = 500.0 * (f[..., 0] - f[..., 1]) + 128.0
    b = 200.0 * (f[..., 1] - f[..., 2]) + 128.0
    lab = jnp.stack([L * jnp.float32(255.0 / 100.0), a, b], axis=-1)
    return jnp.clip(jnp.rint(lab), 0, 255).astype(jnp.uint8)


@jax.jit
def lab_to_rgb(lab):
    """uint8 (..., 3) Lab (OpenCV 8-bit scaling) → uint8 (..., 3) RGB."""
    lab = lab.astype(jnp.float32)
    L = lab[..., 0] * jnp.float32(100.0 / 255.0)
    a = lab[..., 1] - 128.0
    b = lab[..., 2] - 128.0
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0

    def finv(f, lin):
        return jnp.where(f ** 3 > _EPS, f ** 3, lin)

    X = finv(fx, (116.0 * fx - 16.0) / _KAPPA)
    Y = jnp.where(L > _KAPPA * _EPS, fy ** 3, L / _KAPPA)
    Z = finv(fz, (116.0 * fz - 16.0) / _KAPPA)
    xyz = jnp.stack([X, Y, Z], axis=-1) * jnp.asarray(_WHITE, jnp.float32)
    M = jnp.asarray(_XYZ2RGB, jnp.float32)
    rgb = _linear_to_srgb(jnp.einsum("...c,dc->...d", xyz, M,
                                    precision="highest"))
    return jnp.clip(jnp.rint(rgb * 255.0), 0, 255).astype(jnp.uint8)


def bgr_to_lab(bgr):
    return rgb_to_lab(bgr[..., ::-1])


def lab_to_bgr(lab):
    return lab_to_rgb(lab)[..., ::-1]


@jax.jit
def rgb_to_gray(rgb):
    """uint8 (..., 3) RGB → uint8 (...) gray, OpenCV weights + rounding."""
    w = jnp.asarray([0.299, 0.587, 0.114], jnp.float32)
    g = jnp.einsum("...c,c->...", rgb.astype(jnp.float32), w,
                   precision="highest")
    return jnp.clip(jnp.rint(g), 0, 255).astype(jnp.uint8)
