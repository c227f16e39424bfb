"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0] [--frames 5] [--width 1920] [--height 1080]

Phases, one line each (any failure exits non-zero):
  1. device: a CUDA card must be present; prints its name and power limit.
  2. build:  compiles the hand-written kernels from flexlight_tpu_torch/csrc.
  3. kernels vs plain: each kernel against its plain PyTorch version on the
     card, at the slice's own shapes (theater 1080p primary rays and a seeded
     random bounce wavefront for the traversal kernels; the packed planes and
     the FXAA input of one real 1080p frame for the filter passes and FXAA).
     Each kernel takes the same operations in the same order as its plain
     version, so their outputs must be identical; prints the number of
     differing values, the max abs difference and the median CUDA-event
     time of both sides.
  4. slice: theater at 1080p (stand-in wood texture from --seed), full
     pipeline (temporal 4, 3+3+final filter, FXAA, 1 spp, 5 bounces) through
     FlexLight(...).renderer = "pathtracer" and render_frame(); checks the
     output, that every kernel of the path was launched, and that the frames
     match the same frames rendered with every kernel swapped for its plain
     version (<= 1% of pixels over 2e-3, max <= 0.5).
Then one JSON line per the kernels, the card's name and power limit, and a
last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of fn() in ms, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def golden_budget(a, b):
    """(fraction of values over 2e-3, max abs diff) of two images."""
    d = (a.float() - b.float()).abs()
    return float((d > 2e-3).float().mean()), float(d.max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args()

    import torch

    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device: chip_smoke.py drives the port on a CUDA "
              "card and has nothing to check without one", flush=True)
        return 2
    smi = nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    return drive(args, torch.device("cuda:0"), smi)


def drive(args, dev, smi: str) -> int:
    """Phases 2-4 on `dev`."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from flexlight_tpu_torch import Config, _native, reset_global_registry
        from flexlight_tpu_torch.models.pathtracer import KERNELS, PLAIN, KernelSet, PathTracer
        from flexlight_tpu_torch.ops.intersect import BIAS, POW32
        from flexlight_tpu_torch.post.filter_kernel import byte_i
        from flexlight_tpu_torch.scenes import stand_in_wood_texture, theater
    except ImportError as exc:
        fail(f"the flexlight packages are not importable beside this script: {exc}")

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _native.library()
    print(f"[build] kernels built and loaded from flexlight_tpu_torch/csrc in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    w, h = args.width, args.height
    config = Config(temporal=True, temporal_samples=4, filter=True,
                    antialiasing="fxaa", samples_per_ray=1, max_reflections=5)
    texture = stand_in_wood_texture(args.seed)

    def engine():
        reset_global_registry()
        e = theater(texture, device=dev)
        e.canvas = (w, h)
        e.config = config
        return e

    # ---- 3. kernels vs plain --------------------------------------------
    # one real frame with the plain versions, recording each kernel's
    # first inputs
    captured = {}

    def recorder(name, fn):
        def rec(*a):
            captured.setdefault(name, a)
            return fn(*a)
        return rec

    rec_set = KernelSet(*(recorder(n, f) for n, f in zip(KernelSet._fields, PLAIN)))
    e = engine()
    PathTracer(w, h, e.scene, e.camera, config, dev, kernels=rec_set).render_frame()
    missing = [n for n in KernelSet._fields if n not in captured]
    if missing:
        fail(f"the frame did not reach {missing}")

    results = {}

    def differences(ko, po, packed: bool):
        """(number of differing elements, max abs difference) of the
        kernel's and the plain version's outputs; on packed rgba8 planes
        the difference is the largest byte step / 255."""
        ko = ko if isinstance(ko, tuple) else (ko,)
        po = po if isinstance(po, tuple) else (po,)
        count, err = 0, 0.0
        for a, b in zip(ko, po):
            count += int((a != b).sum())
            if packed:
                step = max(int((byte_i(a, i) - byte_i(b, i)).abs().max()) for i in range(4))
                err = max(err, step / 255.0)
            else:
                err = max(err, float((a.double() - b.double()).abs().max()))
        return count, err

    def check(name, label, *args_, packed=False):
        """Kernel vs plain on one input: the outputs must be identical."""
        kernel_fn = lambda: getattr(KERNELS, name)(*args_)  # noqa: E731
        plain_fn = lambda: getattr(PLAIN, name)(*args_)  # noqa: E731
        count, err = differences(kernel_fn(), plain_fn(), packed)
        k_ms = cuda_ms(kernel_fn)
        p_ms = cuda_ms(plain_fn)
        prev = results.get(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
        results[name] = {"max_abs_err": max(prev["max_abs_err"], err),
                         "ms": max(prev["ms"], k_ms), "plain_ms": max(prev["plain_ms"], p_ms)}
        print(f"[kernel] {name} ({label}): tolerance: identical to the plain version "
              f"(same operations in the same order, no fma contraction); "
              f"{count} values differ, max abs {err:.3g} -> {'ok' if count == 0 else 'FAIL'}; "
              f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms", flush=True)
        if count:
            fail(f"{name} ({label}) disagrees with its plain version")

    gen = torch.Generator().manual_seed(args.seed)
    w4, ids, o3, d3, ml, edge = captured["closest_hit"]
    w4s, so3, sd3, sml = captured["any_hit"]
    n = ml.shape[0]
    rand_o = tuple((torch.rand(n, generator=gen) * 80.0 - 40.0).to(dev) for _ in range(3))
    rd = torch.randn(3, n, generator=gen)
    rd = rd / rd.norm(dim=0)
    rand_d = tuple(c.contiguous().to(dev) for c in rd)
    rand_ml = torch.where(torch.rand(n, generator=gen) < 0.1, 0.0, POW32).to(dev)
    rand_len = (torch.rand(n, generator=gen) * 60.0).to(dev)
    check("closest_hit", f"primary, {n} rays", w4, ids, o3, d3, ml, edge)
    check("closest_hit", f"random bounce, {n} rays", w4, ids, rand_o, rand_d, rand_ml, BIAS)
    check("any_hit", f"shadow, {n} rays", w4s, so3, sd3, sml)
    check("any_hit", f"random bounce, {n} rays", w4s, rand_o, rand_d, rand_len)
    for name in ("first_blur", "second_blur"):
        check(name, "packed planes of the frame", *captured[name], packed=True)
    check("final_blur", "packed planes of the frame", *captured["final_blur"])
    check("fxaa", "FXAA input of the frame", *captured["fxaa"])

    # ---- 4. the slice through the user's entry points --------------------
    e = engine()
    plain = PathTracer(w, h, e.scene, e.camera, config, dev, kernels=PLAIN)
    plain_frames = [torch.from_numpy(plain.render_frame()) for _ in range(args.frames)]
    del plain
    torch.cuda.empty_cache()

    e = engine()
    e.renderer = "pathtracer"
    for k in KERNELS:
        k.launches = 0
    frames, frame_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(args.frames):
        t = time.perf_counter()
        frames.append(e.renderer.render_frame())
        frame_ms.append((time.perf_counter() - t) * 1000.0)
    launches = {name: k.launches for name, k in zip(KernelSet._fields, KERNELS)}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[slice] theater {w}x{h}, {args.frames} frames: ms per frame "
          f"{[round(x, 1) for x in frame_ms]} (median of frames 2..: "
          f"{statistics.median(frame_ms[1:] or frame_ms):.1f} ms); peak device memory "
          f"{peak_gb:.2f} GiB; launches {launches}", flush=True)
    last = frames[-1]
    if last.shape != (h, w, 3):
        fail(f"frame shape {last.shape}")
    import numpy as np

    if not np.isfinite(last).all():
        fail("frame has non-finite values")
    if float(last.max()) <= 0.0:
        fail("frame is all black")
    idle = [name for name, c in launches.items() if c == 0]
    if idle:
        fail(f"kernels not launched on the main path: {idle}")
    for i, (a, b) in enumerate(zip(frames, plain_frames)):
        frac, mx = golden_budget(torch.from_numpy(a), b)
        print(f"[slice] frame {i}: kernels vs plain: {frac:.4%} of values over 2e-3, "
              f"max {mx:.4f} (budget 1%, 0.5)", flush=True)
        if frac > 0.01 or mx > 0.5:
            fail("kernel frame outside the golden budget of the plain frame")
    print(f"[slice] output [{h},{w},3], mean {float(last.mean()):.4f}, finite", flush=True)

    if "jax" in sys.modules:
        fail("jax was imported: the port must run without it")
    kernels = []
    for name, k in zip(KernelSet._fields, KERNELS):
        kernels.append({"name": name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces, "launches": launches[name],
                        **results[name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
