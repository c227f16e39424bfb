"""The readings that the limit of `correct` is set from, on the card.

    python3 -m portbench.control --workload <cell> --seeds <n,n,...> [--seconds 3]

For each seed, one process runs the cell's set-up and a short window at
the cell's own load and size, then reads two numbers on the frames the
window kept: the program's (its frames against the reference, as every
run reads it) and the control's (the reference computed with bfloat16
inputs and MRT, the step below the float32 the configuration states, in
the program's place, against the float32 reference). Prints one JSON
line per seed and a last line with the largest program reading and the
smallest control reading. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

from . import check, run, spec
from .reference import io as ref_io


def readings(cfg: dict, mix: dict, seed: int, seconds: float, dev) -> dict:
    with tempfile.TemporaryDirectory(prefix="portbench-control-") as tmp:
        window = run.drive(cfg, mix, seed, seconds, False, dev, tmp)
        engine, ref = check.reference(cfg, dev, tmp)
        record = window["record"]
        poses = ref_io.poses(engine.camera, record["io_log"], record["marks"],
                             cfg["width"], cfg["height"])
        program, control = [], []
        for frame, got in window["kept"]:
            frames = ref.frames_of(frame)
            at = [poses[j] for j in frames]
            want = ref.display_u8(at, frames)
            program.append(check.values_off_pct(got, want))
            lower = ref.display_u8(at, frames, precision="bfloat16")
            control.append(check.values_off_pct(lower, want))
    return {"seed": seed, "frames": [f for f, _ in window["kept"]],
            "poses_off": sum(1 for a, b in zip(poses, record["poses"]) if a != b),
            "program": max(program), "control": max(control), "control_frames": control}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        rows.append(readings(cfg, mix, seed, args.seconds, dev))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "program_max": max(r["program"] for r in rows),
                      "control_min": min(r["control"] for r in rows),
                      "limit": cfg["check"]["limit_values_off_pct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
