"""Device timing and the device peaks table.

Counterpart of the reference's ``GpuTimer`` (cudaEvent elapsed time,
`Integral/cuda_utils.h:134-161`) and warm-up discipline
(`GaussianFilter/gaussian.cu:484-491`).

Protocol (``time_stream_fn``): pre-stage a ring of F *distinct* frames in
device memory, large enough that the working set cannot stay in the card's
L2, run N data-independent iterations inside one jitted ``fori_loop``
(iteration i consumes frame i mod F), force each output to materialize with
``lax.optimization_barrier`` (so the memory write isn't fused away into the
checksum), and difference two loop lengths so dispatch and transfer latency
cancel. The fit is cross-checked against a third loop length, and a per-op
roofline floor (``sol_ms``: the op's minimal memory traffic over the card's
peak bandwidth) is asserted — a measurement that disagrees with itself or
beats physics raises instead of being published.

Timings come only from an accelerator: on the CPU backend every entry point
here raises.
"""

from __future__ import annotations

import subprocess
import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp

# Peak device-memory bandwidth per ``device_kind``; a kind missing here is an
# error, never a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 SXM5 data sheet (80 GB HBM3, 3.35 TB/s)",
    },
}


def _accelerator(device=None):
    device = device if device is not None else jax.devices()[0]
    if device.platform == "cpu":
        raise RuntimeError(
            "no accelerator: JAX is on the CPU backend, so there is no device "
            "time to measure (time: not measured (cpu))")
    return device


def device_peaks(device=None) -> dict:
    """The PEAKS entry for ``device`` (default: the first JAX device)."""
    device = _accelerator(device)
    try:
        return PEAKS[device.device_kind]
    except KeyError:
        raise RuntimeError(
            f"device kind {device.device_kind!r} is not in the peaks table "
            f"(tpuimg.core.timing.PEAKS); add it with its data-sheet source"
        ) from None


def sol_ms(*byte_counts: float, device=None) -> float:
    """Roofline milliseconds for the given device-memory traffic (bytes)."""
    bw = device_peaks(device)["hbm_bytes_per_s"]
    return sum(byte_counts) / bw * 1e3


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi`` name and power limit of the card(s), read in a child
    process that stays off JAX; "unavailable" where there is no NVIDIA
    driver."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "unavailable"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def device_line() -> str:
    """One line naming the backend, card and power limit, printed beside
    every measured result."""
    devs = jax.devices()
    return (f"platform={devs[0].platform} kind={devs[0].device_kind} "
            f"count={len(devs)} nvidia-smi=[{gpu_name_and_power_limit()}]")


@dataclass
class BenchResult:
    name: str
    ms: float  # per-iteration milliseconds (two-point streaming fit)
    ms_min: float
    ms_mean: float
    pixels: int | None = None
    ms_alt: float | None = None  # cross-check fit from the third loop length

    @property
    def gpix_s(self) -> float | None:
        if self.pixels is None:
            return None
        return self.pixels / (self.ms * 1e-3) / 1e9


def _frame_ring(x, min_bytes: int = 256 * 1024 * 1024, max_frames: int = 32):
    """Stack F distinct frames (rolled copies of x) so the input working set
    is several times the card's L2; F is a power of two for a cheap i % F."""
    frame_bytes = x.size * x.dtype.itemsize
    f = 1
    while f < max_frames and f * frame_bytes < min_bytes:
        f *= 2
    frames = jnp.stack(
        [jnp.roll(x, (11 * i) % max(x.shape[-1], 1), axis=-1) for i in range(f)]
    )
    return jax.block_until_ready(frames), f


def time_stream_fn(fn, x, *, iters: int = 32, warmup_reps: int = 2,
                   name: str = "op", pixels: int | None = None,
                   sol_ms: float | None = None,
                   consistency_tol: float = 0.25) -> BenchResult:
    """Streaming-throughput timing: see the module docstring for the protocol.

    ``fn(frame)`` must accept one array shaped like ``x``. Raises
    RuntimeError on the CPU backend, if the measurement is faster than
    ``sol_ms`` (physically impossible), or if the two independent fits
    disagree by more than ``consistency_tol`` (relative).
    """
    _accelerator()
    frames, f = _frame_ring(x)

    # frames and n are jit ARGUMENTS (a closed-over device array would be
    # embedded in the program as a constant — hundreds of MB per compile);
    # one compiled program serves every loop length
    @jax.jit
    def run(frames_arg, n):
        def body(i, c):
            xi = jax.lax.dynamic_index_in_dim(
                frames_arg, jnp.remainder(i, f), 0, keepdims=False
            )
            out = fn(xi)
            if not isinstance(out, (tuple, list)):
                out = (out,)
            # EVERY output must enter the dependency chain: summing only
            # out[0] would let XLA dead-code-eliminate the other outputs
            # and time a fraction of the op. The barrier forces the full
            # buffers to materialize; the checksum then reads only one row
            # each, so measured traffic is the op's own read+write.
            out = jax.lax.optimization_barrier(tuple(out))
            acc = c
            for o in out:
                chk = o[..., :1, :] if o.ndim >= 2 else o
                acc = acc + jnp.sum(chk.astype(jnp.float32))
            return acc

        return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

    def measure(n, tries=3):
        best = float("inf")
        for _ in range(tries):
            t0 = time.perf_counter()
            float(run(frames, jnp.int32(n)))  # scalar fetch forces completion
            best = min(best, time.perf_counter() - t0)
        return best

    for _ in range(warmup_reps):
        float(run(frames, jnp.int32(2)))

    # Adapt loop lengths to the op: the differenced span must dwarf the
    # host<->device round trip and its jitter. Aim for ~150 ms at n_hi.
    est = max((measure(64, tries=2) - measure(4, tries=2)) / 60, 1e-6)
    n_hi = int(min(max(iters, 0.150 / est), 8192))
    n_mid = max(2, n_hi // 2)
    n_lo = max(1, n_hi // 4)
    if n_mid >= n_hi:
        n_hi = n_mid + 1
    lengths = (n_lo, n_mid, n_hi)

    # interleave loop lengths so clock/queue drift cancels
    t = {n: float("inf") for n in lengths}
    for _ in range(3):
        for n in lengths:
            t[n] = min(t[n], measure(n, tries=2))

    ms = (t[n_hi] - t[n_mid]) / (n_hi - n_mid) * 1e3
    ms_alt = (t[n_mid] - t[n_lo]) / (n_mid - n_lo) * 1e3
    if ms <= 0 or ms_alt <= 0:
        raise RuntimeError(
            f"{name}: non-positive per-iteration time (ms={ms:.5f}, "
            f"alt={ms_alt:.5f}) — loop lengths too short for this op"
        )
    rel = abs(ms - ms_alt) / max(ms, ms_alt)
    if rel > consistency_tol:
        raise RuntimeError(
            f"{name}: streaming fits disagree ({ms:.4f} vs {ms_alt:.4f} ms, "
            f"{rel:.0%} > {consistency_tol:.0%}) — measurement unstable"
        )
    if sol_ms is not None and ms < sol_ms * 0.98:
        raise RuntimeError(
            f"{name}: measured {ms:.4f} ms is faster than the memory-bandwidth "
            f"roofline {sol_ms:.4f} ms — harness artifact, not a result"
        )
    return BenchResult(name=name, ms=ms, ms_min=min(ms, ms_alt),
                       ms_mean=(ms + ms_alt) / 2, pixels=pixels, ms_alt=ms_alt)
