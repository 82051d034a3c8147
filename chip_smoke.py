"""Smoke check of tpuimg on one NVIDIA GPU: ``python chip_smoke.py``.

Phases:
  (a) banner: JAX platform, device kind and count, JAX version, XLA_FLAGS,
      compile-cache directory, the card's name and power limit from
      nvidia-smi, and whether cv2 / PIL / the native loader import. Exits 2
      unless JAX's first device is a GPU.
  (b) every ``bench.py`` configuration compiled at full width through the
      public ops and compared with the NumPy oracle
      (``tpuimg/oracle/numpy_ref.py``), with each compiled program's
      memory analysis and the device's peak memory in use;
  (c) ``enhance`` over a short stream of distinct 4K frames, each output
      fetched to the host: frames/s, with compile time as set-up;
  (d) one configuration through the timing harness (``time_stream_fn``).

``--four-cards`` runs only the sharded path of ``tpuimg.parallel`` on four
GPUs — an 8K frame row-sharded over ``sp=4`` and a ``data=4`` batch of 1080p
frames — against the single-device ops.

Any failed phase exits non-zero. The last line of a passing run is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

import numpy as np


def banner():
    """Phase (a). Returns JAX's first device."""
    import jax

    from tpuimg.core.cache import enable_compile_cache
    from tpuimg.core.timing import gpu_name_and_power_limit

    cache_dir = enable_compile_cache()
    dev = jax.devices()[0]
    print(f"jax {jax.__version__}: platform={dev.platform} "
          f"kind={dev.device_kind} count={len(jax.devices())}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
          f"compile cache={cache_dir}")
    for mod in ("cv2", "PIL"):
        try:
            importlib.import_module(mod)
            print(f"{mod}: importable")
        except ImportError as e:
            print(f"{mod}: not importable ({e})")
    from tpuimg import native

    print(f"native loader: {'available' if native.available() else 'unavailable'}")
    print(f"nvidia-smi name, power.limit: {gpu_name_and_power_limit()}")
    return dev


def op_checks(s: int = 1):
    """Phase (b) cases: (name, fn, input, reference, tol) for every
    ``bench.py`` configuration. ``s`` divides the frame sides (1 = the real
    widths; the CPU tests use larger ``s``). ``reference`` maps the host
    input to the expected output."""
    import jax.numpy as jnp

    import tpuimg
    from tpuimg.oracle import (clahe_ref, gaussian_ref, guided_filter_ref,
                               hist_equalize_ref, integral_ref, open_ref)
    from tpuimg.pipeline import enhance

    rng = np.random.default_rng(0)
    h4, w4, h1, w1 = 2160 // s, 3840 // s, 1080 // s, 1920 // s
    u4 = rng.integers(0, 256, (h4, w4), dtype=np.uint8)
    f4 = rng.random((h4, w4), dtype=np.float32)
    f1 = rng.random((h1, w1), dtype=np.float32)
    b16 = rng.integers(0, 256, (16, h1, w1), dtype=np.uint8)

    def per_frame(ref):
        return lambda b: np.stack([ref(f) for f in b])

    def enhance_ref(x):
        eq = clahe_ref(x, 2.0, 8, 8)
        f = eq.astype(np.float32) * np.float32(1.0 / 255.0)
        q = guided_filter_ref(f, gaussian_ref(f, 2, 1.5), 8, 1e-3,
                              border="reflect101")
        return np.clip(np.rint(q * 255.0), 0, 255).astype(np.uint8)

    def clahe_u8(x):
        return np.asarray(tpuimg.clahe(x, 40.0, 8, 8))

    def clahe_f32_trunc(x):
        blend = tpuimg.clahe(x, 40.0, 8, 8, _out_f32=True)
        return jnp.clip(jnp.trunc(blend), 0, 255).astype(jnp.uint8)

    def guided_general(g):
        return tpuimg.guided_filter(g[0], g[1], 8, 1e-3, border="reflect101")

    return [
        ("gaussian_r2_1080p", lambda x: tpuimg.gaussian(x, 2, 1.5), f1,
         lambda x: gaussian_ref(x, 2, 1.5), 1e-5),
        ("integral_4k", tpuimg.integral, u4, integral_ref, 0),
        ("hist_equalize_4k", tpuimg.hist_equalize, u4, hist_equalize_ref, 0),
        ("hist_equalize_1080p_b16", tpuimg.hist_equalize, b16,
         per_frame(hist_equalize_ref), 0),
        ("clahe_4k_8x8", lambda x: tpuimg.clahe(x, 40.0, 8, 8), u4,
         lambda x: clahe_ref(x, 40.0, 8, 8), 1),
        # the enhance bridge: truncating the f32 blend is the u8 output
        ("clahe_4k_8x8_f32_trunc_vs_u8", clahe_f32_trunc, u4, clahe_u8, 0),
        ("guided_r8_4k_self", lambda x: tpuimg.guided_filter(
            x, x, 8, 1e-3, border="reflect101"), f4,
         lambda x: guided_filter_ref(x, x, 8, 1e-3, border="reflect101"),
         1e-4),
        ("guided_r8_4k_general", guided_general, np.stack([f4, f4[::-1]]),
         lambda g: guided_filter_ref(g[0], g[1], 8, 1e-3,
                                     border="reflect101"), 1e-4),
        ("morph_open_r15_4k_b2", lambda x: tpuimg.morph_open(x, 15),
         np.stack([u4, u4[:, ::-1]]), per_frame(lambda f: open_ref(f, 15)), 0),
        ("enhance_4k_staged", lambda x: enhance(x, impl="staged"), u4,
         enhance_ref, 1),
        ("enhance_4k_fused_vs_staged", enhance, u4,
         lambda x: np.asarray(enhance(x, impl="staged")), 1),
    ]


def run_op_checks(s: int = 1) -> list[str]:
    """Phase (b): compile, run and compare each case. Returns failures."""
    import jax

    failures = []
    dev = jax.devices()[0]
    for name, fn, x, ref, tol in op_checks(s):
        xd = jax.device_put(x)
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(xd).compile()
        t_compile = time.perf_counter() - t0
        got = np.asarray(compiled(xd))
        t0 = time.perf_counter()
        want = np.asarray(ref(x))
        t_ref = time.perf_counter() - t0
        diff = (float(np.abs(got.astype(np.float64)
                             - want.astype(np.float64)).max())
                if got.shape == want.shape else float("inf"))
        ok = diff <= tol
        if not ok:
            failures.append(name)
        ma = compiled.memory_analysis()
        mem = ("n/a" if ma is None else
               f"args={ma.argument_size_in_bytes} out={ma.output_size_in_bytes}"
               f" temp={ma.temp_size_in_bytes}")
        stats = dev.memory_stats() or {}
        print(f"check {name}: shape={tuple(x.shape)} maxdiff={diff:g} "
              f"tol={tol:g} [{'OK' if ok else 'FAIL'}] compile={t_compile:.2f}s"
              f" reference={t_ref:.2f}s memory_analysis({mem}) "
              f"peak_bytes_in_use={stats.get('peak_bytes_in_use', 'n/a')}",
              flush=True)
    return failures


def run_stream(n_frames: int = 16, hw=(2160, 3840)) -> float:
    """Phase (c): ``enhance`` over distinct frames through the public call,
    each output fetched to the host. Returns frames/s after set-up (None
    on the CPU backend, where time is not measured)."""
    import jax.numpy as jnp

    from tpuimg.pipeline import enhance

    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (n_frames,) + tuple(hw), dtype=np.uint8)
    t0 = time.perf_counter()
    first = np.asarray(enhance(jnp.asarray(frames[0])))
    setup = time.perf_counter() - t0
    assert first.shape == tuple(hw) and first.dtype == np.uint8
    t0 = time.perf_counter()
    for frame in frames[1:]:
        out = np.asarray(enhance(jnp.asarray(frame)))
        assert out.shape == tuple(hw)
    dt = time.perf_counter() - t0
    import jax

    if jax.devices()[0].platform == "cpu":
        print(f"stream enhance {hw[1]}x{hw[0]}: {n_frames} frames OK; "
              f"time: not measured (cpu)", flush=True)
        return None
    fps = (n_frames - 1) / dt
    print(f"stream enhance {hw[1]}x{hw[0]}: {n_frames - 1} frames after "
          f"set-up, {fps:.2f} frames/s host to host; set-up (first call, "
          f"compile included) {setup:.2f}s", flush=True)
    return fps


def run_timing():
    """Phase (d): the integral_4k config through ``time_stream_fn``."""
    import jax
    import jax.numpy as jnp

    import tpuimg
    from tpuimg.core.timing import device_line, sol_ms, time_stream_fn

    img = jax.random.randint(jax.random.PRNGKey(0), (2160, 3840), 0, 256,
                             jnp.int32).astype(jnp.uint8)
    sol = sol_ms(img.size + 4 * img.size)
    r = time_stream_fn(tpuimg.integral, img, name="integral_4k",
                       pixels=img.size, sol_ms=sol)
    print(f"timing integral_4k: {r.ms:.5f} ms (alt fit {r.ms_alt:.5f}) "
          f"{r.gpix_s:.2f} GPix/s, roofline share {sol / r.ms:.3f} "
          f"[{device_line()}]", flush=True)
    return r


def run_four_cards(frame_hw=(4320, 7680), batch_hw=(1080, 1920), n=4,
                   **sizes) -> list:
    """The sharded path on ``n`` devices vs the single-device ops: one
    frame row-sharded over sp=n, and a data=n batch. Returns failures."""
    from __graft_entry__ import check_results, sharded_checks
    from tpuimg.parallel import make_mesh

    rng = np.random.default_rng(2)
    legs = [
        (f"frame {frame_hw[1]}x{frame_hw[0]} over (data=1, sp={n})",
         make_mesh(1, n), rng.integers(0, 256, frame_hw, dtype=np.uint8)),
        (f"batch {n}x{batch_hw[1]}x{batch_hw[0]} over (data={n}, sp=1)",
         make_mesh(n, 1),
         rng.integers(0, 256, (n,) + tuple(batch_hw), dtype=np.uint8)),
    ]
    failures = []
    for label, mesh, x in legs:
        results = sharded_checks(mesh, x, **sizes)
        bad = check_results(results, n)
        failures += [(label,) + tuple(b) for b in bad]
        for name, diff, tol, devices in results:
            ok = diff <= tol and len(devices) >= n
            print(f"sharded {label} {name}: maxdiff vs one device={diff:g} "
                  f"tol={tol:g} output shards on devices {devices} "
                  f"[{'OK' if ok else 'FAIL'}]", flush=True)
    return failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded path on four GPUs")
    args = p.parse_args(argv)

    dev = banner()
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    import jax

    count = len(jax.devices())
    if args.four_cards:
        if count < 4:
            print(f"chip_smoke: --four-cards needs 4 GPUs, JAX sees {count}",
                  file=sys.stderr)
            return 2
        failures = run_four_cards()
        if failures:
            print(f"chip_smoke: sharded checks failed: {failures}",
                  file=sys.stderr)
            return 1
    else:
        failures = run_op_checks()
        if failures:
            print(f"chip_smoke: checks failed: {failures}", file=sys.stderr)
            return 1
        run_stream()
        run_timing()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
