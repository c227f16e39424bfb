"""The comparison that decides `correct`: the camera pose of every render
call, and each kept frame against the reference's frame of the same
poses and frame numbers.

Two numbers are compared. `poses_off` counts the render calls whose pose,
as the program's camera held it, differs from the pose the reference
works out by replaying the viewer's calls on a frozen copy of the fly
camera (reference/io.py); its limit is 0. `frame_values_off_pct` is the
largest share of a kept frame's uint8 values (H x W x 3) unlike the
reference's frame, rendered from the reference's own poses, in percent.
The program's kernels take their plain versions' operations in the same
order, so a sound frame reads 0; the limit comes from the configuration's
file (`check.limit_values_off_pct`), set from the sound runs' and the
bfloat16 control's readings (PERF.md).

The configuration names its scene file (`scenes/<scene>.py`, whose
`build_reference` builds the frozen copy's scene) and its reference
renderer (`reference/renderers/<reference>.py`, whose `Reference` renders
the delivered frame).
"""

from __future__ import annotations

import numpy as np

from . import spec
from .reference import io as ref_io


def values_off_pct(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return 100.0
    return float(np.count_nonzero(got != want)) * 100.0 / got.size


def reference(cfg: dict, device, tmpdir: str):
    """The configuration's reference renderer on its own scene."""
    engine, at = spec.part("scenes", cfg["scene"]).build_reference(cfg, device, tmpdir)
    return engine, spec.part("reference/renderers", cfg["reference"]).Reference(
        cfg, engine, at, device)


def compare(cfg: dict, device, tmpdir: str, record: dict, kept: list,
            precision: str = "float32", count: bool = False) -> dict:
    """`record`: the run's "io_log", "marks" and "poses" (program.Session);
    `kept`: (frame number, delivered uint8 frame) pairs. Returns the
    reference's poses, the pose count off, the share of values off for
    each kept frame, the reference's cast counts of the last kept frame
    (with `count`) and the number of MRT passes they cover, and the
    scene's shape."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    engine, ref = reference(cfg, device, tmpdir)
    poses = ref_io.poses(engine.camera, record["io_log"], record["marks"],
                         cfg["width"], cfg["height"])
    poses_off = sum(1 for a, b in zip(poses, record["poses"]) if a != b)
    poses_off += abs(len(poses) - len(record["poses"]))
    readings, counts, passes = [], None, 0
    for i, (frame, got) in enumerate(kept):
        frames = ref.frames_of(frame)
        args = ([poses[j] for j in frames], frames, precision)
        if count and i == len(kept) - 1:   # the window's last frame: in the traced stretch
            with ref.counting() as counts:
                want = ref.display_u8(*args)
            passes = len(frames)
        else:
            want = ref.display_u8(*args)
        readings.append(values_off_pct(got, want))
    return {"poses": poses, "poses_off": poses_off, "readings": readings, "counts": counts,
            "passes": passes, "shape": ref.shape()}
