"""Benchmark harness: the per-op configurations on the local accelerator.

Each configuration runs through ``tpuimg.core.timing.time_stream_fn``: a
ring of distinct device-resident frames streamed through N data-independent
iterations inside one jit, outputs forced to materialize, latency cancelled
by differencing loop lengths, a third loop length cross-checking the fit, and
a per-op memory-bandwidth roofline floor asserted — the counterpart of the
reference's GpuTimer + warm-up + nrepeats discipline
(GaussianFilter/gaussian.cu:484-516).

Prints a table on stderr and, as the last stdout line, one JSON object with
the device (platform, kind, count, nvidia-smi name and power limit) and each
configuration's ms, GPix/s and roofline share. Exits 1 if any configuration
fails, 2 without an accelerator.

    python bench.py
"""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp

import tpuimg
from tpuimg.core.cache import enable_compile_cache
from tpuimg.core.timing import (gpu_name_and_power_limit, sol_ms,
                                time_stream_fn)
from tpuimg.pipeline import enhance

MB4K_U8 = 2160 * 3840          # one 4K u8 frame, bytes
MB4K_F32 = 2160 * 3840 * 4
MB1080_F32 = 1080 * 1920 * 4


def configs():
    """(name, fn, arg, pixels, iters, roofline bytes) per configuration.

    The bytes are the algorithm's minimal device-memory traffic: one read of
    each input and one write of each output."""
    key = jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(key, 3)
    img4k_u8 = jax.random.randint(k1, (2160, 3840), 0, 256, jnp.int32).astype(jnp.uint8)
    img4k_f = jax.random.uniform(k2, (2160, 3840), jnp.float32)
    img1080_f = jax.random.uniform(k3, (1080, 1920), jnp.float32)
    batch4k_u8 = jnp.stack([img4k_u8, img4k_u8[:, ::-1]])
    PIX4K, PIX1080 = 2160 * 3840, 1080 * 1920
    return [
        ("gaussian_5x5_1080p", lambda x: tpuimg.gaussian(x, 2, 1.5), img1080_f,
         PIX1080, 48, 2 * MB1080_F32),
        ("integral_4k", tpuimg.integral, img4k_u8, PIX4K, 32,
         MB4K_U8 + 4 * MB4K_U8),
        # hist read + map read + map write
        ("hist_equalize_4k", tpuimg.hist_equalize, img4k_u8, PIX4K, 32,
         3 * MB4K_U8),
        # 16 independent 1080p frames, one histogram/LUT per frame
        ("hist_equalize_1080p_b16", tpuimg.hist_equalize,
         jnp.stack([jnp.roll(img4k_u8[:1080, :1920], i, axis=1)
                    for i in range(16)]), 16 * PIX1080, 16,
         3 * 16 * 1080 * 1920),
        ("clahe_4k_8x8", lambda x: tpuimg.clahe(x, 40.0, 8, 8), img4k_u8,
         PIX4K, 24, 3 * MB4K_U8),
        # fused-path semantics (reflect101, 1/ksz^2) — the reference's own 4K
        # flagship demo (cudaSmallGuidedDemo -> hGuidedFilter,
        # GuidedFilter/main.cpp:178-312); I == p: one read + one write
        ("guided_r8_4k",
         lambda x: tpuimg.guided_filter(x, x, 8, 1e-3, border="reflect101"),
         img4k_f, PIX4K, 16, 2 * MB4K_F32),
        # general path: distinct guide/source (the reference demo's
        # src != guide protocol, GuidedFilter/main.cpp:178)
        ("guided_r8_4k_general",
         lambda s: tpuimg.guided_filter(s[0], s[1], 8, 1e-3,
                                        border="reflect101"),
         jnp.stack([img4k_f, img4k_f[::-1]]), PIX4K, 16, 3 * MB4K_F32),
        # pixels count both stages like the reference would launch them
        ("morph_31x31_4k_batch2", lambda x: tpuimg.morph_open(x, 15),
         batch4k_u8, 2 * 2 * PIX4K, 16, 2 * 2 * MB4K_U8),
        # algorithm-minimal floor: the u8 frame read once and written once
        ("enhance_pipeline_4k", enhance, img4k_u8, PIX4K, 12, 2 * MB4K_U8),
    ]


def main() -> int:
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        print("bench: no accelerator (JAX platform cpu); time: not measured",
              file=sys.stderr)
        return 2
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()),
              "nvidia_smi": gpu_name_and_power_limit()}
    print(f"device: {device}", file=sys.stderr)
    detail, failed = {}, []
    for name, fn, arg, pix, iters, nbytes in configs():
        try:
            sol = sol_ms(nbytes)
            r = time_stream_fn(fn, arg, iters=iters, name=name, pixels=pix,
                               sol_ms=sol)
            detail[name] = {"ms": r.ms, "ms_alt": r.ms_alt,
                            "gpix_s": r.gpix_s, "roofline_ms": sol,
                            "roofline_share": sol / r.ms}
            print(f"{name:24s} {r.ms:9.4f} ms  {r.gpix_s:8.2f} GPix/s  "
                  f"(alt {r.ms_alt:8.4f}, roofline {sol:7.4f} ms, "
                  f"share {sol / r.ms:.3f})", file=sys.stderr)
        except Exception as e:  # report every config, then fail the run
            failed.append(name)
            detail[name] = {"error": str(e)[:300]}
            print(f"{name:24s} ERROR {e}", file=sys.stderr)
    print(json.dumps({"device": device, "configs": detail,
                      "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
