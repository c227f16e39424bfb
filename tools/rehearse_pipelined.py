"""Loop the pipelined-fetch check of chip_smoke.py (phase 10 (a)) on a
small frame, to see whether a pipelined frame ever differs from its
synchronous frame.

    python3 tools/rehearse_pipelined.py [--loops 20] [--width 64] [--height 36]
                                        [--device cpu] [--seed 0] [--calls 24]
                                        [--threads 2]

Each loop makes six fresh path tracers on theater (the headline config:
temporal 4, 3+3+final filter, FXAA, 1 spp, 5 bounces; the hash RNG) at
pipelined depths 0, 4, 1, 1, 4, 0, calls render_frame_u8() --calls times
on each with the camera moved 0.05 before every call, and holds call i of
each run against frame max(0, i - depth) of the loop's first (synchronous)
run, as phase 10 (a) does. On the CPU the kernels' plain versions render.
Prints one line a loop (the calls that differ, per run) and, last, a JSON
summary: loops, runs, calls compared and calls that differed."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ORDER = (0, 4, 1, 1, 4, 0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--loops", type=int, default=20)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=36)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calls", type=int, default=24)
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args()

    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from flexlight_tpu_torch import Config, reset_global_registry
    from flexlight_tpu_torch.scenes import stand_in_wood_texture, theater

    torch.set_num_threads(args.threads)
    config = Config(temporal=True, temporal_samples=4, filter=True, antialiasing="fxaa",
                    samples_per_ray=1, max_reflections=5)
    texture = stand_in_wood_texture(args.seed)

    def run(depth):
        reset_global_registry()
        e = theater(texture, device=args.device)
        e.canvas = (args.width, args.height)
        e.config = config
        e.renderer = "pathtracer"
        r = e.renderer
        r.pipelined = depth
        x0 = e.camera.x
        frames = []
        for i in range(args.calls):
            e.camera.x = x0 + 0.05 * i
            frames.append(r.render_frame_u8())
        return frames

    total = compared = 0
    t0 = time.perf_counter()
    for loop in range(args.loops):
        sync = None
        wrong_runs = []
        for depth in ORDER:
            frames = run(depth)
            if sync is None:
                sync = frames
            wrong = [i for i, f in enumerate(frames)
                     if not np.array_equal(f, sync[max(0, i - depth)])]
            wrong_runs.append(wrong)
            total += len(wrong)
            compared += len(frames)
        print(f"loop {loop + 1}: calls that differ per run (depths {ORDER}): {wrong_runs} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
    print(json.dumps({"loops": args.loops, "runs": args.loops * len(ORDER),
                      "calls_compared": compared, "calls_differing": total,
                      "size": [args.width, args.height], "device": args.device}), flush=True)
    return 1 if total else 0


if __name__ == "__main__":
    sys.exit(main())
