"""Where the time of one of the port's frames goes, on one CUDA card.

    python3 tools/profile_frame.py [--scene theater|dragon|wave|example2]
                                   [--renderer pathtracer|rasterizer|simple]
                                   [--scheme auto|fused_split|fused|kernel|sparse|scan|packet]
                                   [--antialiasing fxaa|taa] [--shade-kernel auto|on|off]
                                   [--device cuda:0] [--seed 0] [--timed 8] [--profiled 3]
                                   [--width 1920] [--height 1080]
                                   [--out build/profile_frame_<scene>_<scheme>[_shade_on|_shade_off].json]

Renders --scene with the headline config (temporal 4, 3+3+final filter,
FXAA, 1 spp, 5 bounces) through flexlight_tpu_torch's PathTracer on
--device with --scheme: theater (stand-in wood texture from --seed;
"auto" resolves to "fused_split"), the dragon stand-in (its seeded OBJ
files written under build/objects/; 44,890 triangles, "auto" resolves to
"sparse"; the monkey head's look-at animation runs before every frame)
wave (50 triangles, 1x1 textures: "auto" resolves to "fused_split",
and it is eligible for "fused"; its pillars move before every frame) or
example2, the many-lights stress scene (62 triangles, 64 lights: "auto"
resolves to "fused_split"; before every frame its animate moves a light
and a cuboid and rebuilds the scene buffers, update_scene, which the
timed and the profiled frames include).
--shade-kernel sets the renderer's shade_kernel switch (kernel and sparse
schemes: the shading kernels of ops.shade): auto (None, the default: a
kernel where the scene allows), on (True) or off (False, the eager
loop). --renderer rasterizer
renders with the Rasterizer and the default Config instead ("auto":
"kernel" below 4096 triangles, "sparse" from there), --renderer simple
with the SimplePathTracer (scan casts); --antialiasing taa takes TAA in
place of FXAA.
It reports:

  * frame ms: host wall time of render_frame() (which returns the frame on
    the host), median of --timed frames after two warm-up frames;
  * device ms per frame, by part: torch.profiler over --profiled frames of
    the renderer's _render_device() plus a synchronize; the sum of the device
    time of every kernel the card ran, split into the port's kernels (by
    their CUDA function names) and all other kernels (torch's own);
  * kernels per frame: every kernel the card ran, the port's and torch's;
  * the device ms of each launch of the port's kernels in the first
    profiled frame, in launch order (the shading kernels: bounce 0 first);
  * busy share in the profiled run: device ms / wall ms of those profiled
    frames. The profiler slows the host's launches, so this is a lower
    bound of the unprofiled frame's busy share;
  * idle share of the unprofiled frame, derived: 1 - (device ms per frame
    from the profile) / (median frame ms). Device time per kernel does not
    depend on the host, so it carries over from the profiled frames.

Prints the card's name and power limit, a table, and writes the numbers as
JSON to --out. Exits non-zero if no CUDA device is present or the profiler
saw no device time.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# CUDA function name -> part of the frame
PARTS = (("fl_closest_hit", "closest hit"), ("fl_any_hit", "any hit"),
         ("fl_sparse_flags", "sparse tile flags"), ("fl_sparse_key", "sparse nearest2 key"),
         ("fl_sparse_closest", "sparse closest hit"), ("fl_sparse_any", "sparse any hit"),
         ("fl_sp_pre", "PRE (fused)"), ("fl_sp_post", "POST (fused)"),
         ("fl_sp_live_list", "live list (POST, shade)"),
         ("fl_fused_frame", "whole frame (fused)"),
         ("fl_shade", "shade"), ("fl_alive_list", "alive list (interp_shade)"),
         ("fl_interp_shade", "interp_shade"),
         ("fl_disc_first", "disc first"), ("fl_disc_second", "disc second"),
         ("fl_disc_final", "disc final"), ("fl_fxaa", "FXAA"),
         ("fl_raster_surface", "raster surface"), ("fl_raster_rays", "raster shadow rays"),
         ("fl_raster_shade", "raster shade"))
OTHER = ("torch ops (shading or texture glue, worklist sort and compaction, temporal, "
         "packing, vote repair)")


def part_of(kernel_name: str) -> str:
    for prefix, part in PARTS:
        if prefix in kernel_name:  # names may come mangled or demangled
            return part
    return OTHER


def device_kernels(prof):
    """(name, device us) of every kernel the profiler recorded, in the
    order they started."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        out.append((ev.time_range.start, ev.name, float(ev.time_range.elapsed_us())))
    return [(name, us) for _, name, us in sorted(out, key=lambda e: e[0])]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="theater",
                    choices=("theater", "dragon", "wave", "example2"))
    ap.add_argument("--renderer", default="pathtracer",
                    choices=("pathtracer", "rasterizer", "simple"))
    ap.add_argument("--scheme", default="auto",
                    choices=("auto", "fused_split", "fused", "kernel", "sparse", "scan",
                             "packet"))
    ap.add_argument("--antialiasing", default="fxaa", choices=("fxaa", "taa"))
    ap.add_argument("--shade-kernel", default="auto", choices=("auto", "on", "off"))
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timed", type=int, default=8)
    ap.add_argument("--profiled", type=int, default=3)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    shade_kernel = {"auto": None, "on": True, "off": False}[args.shade_kernel]
    tag = ("" if shade_kernel is None else f"_shade_{args.shade_kernel}") + (
        "_taa" if args.antialiasing == "taa" else "")
    out = args.out or os.path.join(
        ROOT, "build", f"profile_frame_{args.renderer}_{args.scene}_{args.scheme}{tag}.json")

    import torch
    from torch.autograd import DeviceType

    dev = torch.device(args.device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        print("FAIL: profile_frame.py measures the frame on a CUDA card; none is present",
              flush=True)
        return 2
    sys.path.insert(0, ROOT)
    from flexlight_tpu_torch import Config, reset_global_registry
    from flexlight_tpu_torch.scenes import dragon, example2, stand_in_wood_texture, theater, wave

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(dev)} | {smi}", flush=True)

    config = Config(temporal=True, temporal_samples=4, filter=True,
                    antialiasing=args.antialiasing, samples_per_ray=1, max_reflections=5)
    reset_global_registry()
    if args.scene == "dragon":
        e, animate = dragon(args.seed, os.path.join(ROOT, "build", "objects"), device=dev)
    elif args.scene == "wave":
        e, animate = wave(device=dev)
    elif args.scene == "example2":
        e, animate = example2(device=dev)
    else:
        e, animate = theater(stand_in_wood_texture(args.seed), device=dev), None
    # the renderer the engine holds: the one a scene's animate updates
    e.canvas = (args.width, args.height)
    if args.renderer == "simple":
        e.config = config
        e.api = "simple"
    elif args.renderer == "rasterizer":
        e.config = Config(antialiasing=args.antialiasing)
        e.renderer = "rasterizer"
    else:
        e.config = config
        e.renderer = "pathtracer"
        e.renderer.shade_kernel = shade_kernel
    tracer = e.renderer
    if args.renderer != "simple":
        tracer.scheme = args.scheme
    scheme = tracer.resolved_scheme() if args.renderer != "simple" else "scan"
    frames = 0

    def step(fn):
        nonlocal frames
        if animate is not None:
            animate(frames)
        frames += 1
        return fn()

    for _ in range(2):
        step(tracer.render_frame)

    frame_ms = []
    for _ in range(args.timed):
        t = time.perf_counter()
        step(tracer.render_frame)
        frame_ms.append((time.perf_counter() - t) * 1000.0)
    frame_med = statistics.median(frame_ms)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(args.profiled):
            step(tracer._render_device)
        torch.cuda.synchronize(dev)
        prof_wall_ms = (time.perf_counter() - t) * 1000.0 / args.profiled

    kernels = device_kernels(prof)
    if not kernels or sum(us for _, us in kernels) <= 0.0:
        print("FAIL: the profiler recorded no device time", flush=True)
        return 1
    parts = {part: 0.0 for _, part in PARTS}
    parts[OTHER] = 0.0
    counts = dict.fromkeys(parts, 0.0)
    launches_ms = {part: [] for _, part in PARTS}
    for name, us in kernels:
        parts[part_of(name)] += us / 1000.0 / args.profiled
        counts[part_of(name)] += 1.0 / args.profiled
        launches_ms.get(part_of(name), []).append(us / 1000.0)
    # the port's kernels launch by launch in the first profiled frame (the
    # shading kernels and the lists: bounce 0 first)
    first_frame = {part: ms[:len(ms) // args.profiled] for part, ms in launches_ms.items() if ms}
    busy = sum(parts.values())
    launches = len(kernels) / args.profiled
    top = sorted(((e.key, e.self_device_time_total / 1000.0 / args.profiled,
                   e.count / args.profiled) for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU and e.self_device_time_total > 0),
                 key=lambda t: -t[1])[:8]

    print(f"[frame] {args.renderer}, {args.scene} {args.width}x{args.height}, scheme {scheme}, "
          f"antialiasing {args.antialiasing}, shade_kernel {args.shade_kernel}: render_frame() ms "
          f"{[round(x, 1) for x in frame_ms]}, median {frame_med:.1f}", flush=True)
    print("| Part | Device ms per frame | Kernels per frame |", flush=True)
    print("| --- | --- | --- |", flush=True)
    for part, ms in parts.items():
        print(f"| {part} | {ms:.3f} | {counts[part]:.0f} |", flush=True)
    print(f"| device busy | {busy:.3f} | {launches:.0f} |", flush=True)
    print(f"[profile] {launches:.0f} kernels per frame; profiled frame wall "
          f"{prof_wall_ms:.1f} ms, busy share there {busy / prof_wall_ms:.3f}; "
          f"unprofiled frame {frame_med:.1f} ms, derived idle share "
          f"{1.0 - busy / frame_med:.3f}", flush=True)
    for part, ms in first_frame.items():
        print(f"[launches] {part}, device ms of each launch of the first profiled frame: "
              + ", ".join(f"{x:.4f}" for x in ms), flush=True)
    print("[profile] largest torch ops by the device time of their kernels, ms and calls "
          "per frame: " + "; ".join(f"{n} {ms:.2f} ({c:.0f})" for n, ms, c in top), flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"device": smi, "renderer": args.renderer, "scene": args.scene,
                   "scheme": scheme, "antialiasing": args.antialiasing,
                   "shade_kernel": args.shade_kernel,
                   "width": args.width, "height": args.height,
                   "frame_ms": frame_ms, "frame_ms_median": frame_med,
                   "device_ms_per_frame": parts, "kernels_per_frame_by_part": counts,
                   "device_ms_per_launch_first_frame": first_frame,
                   "device_busy_ms": busy,
                   "kernels_per_frame": launches, "profiled_wall_ms": prof_wall_ms,
                   "busy_share_profiled": busy / prof_wall_ms,
                   "idle_share_derived": 1.0 - busy / frame_med,
                   "top_torch_ops_ms": {n: ms for n, ms, _ in top}}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
