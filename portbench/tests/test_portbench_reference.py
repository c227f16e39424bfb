"""The reference and the comparison on the CPU: the reference agrees with
the program at 24 px on every scene file, poses included, the bfloat16
control does not, a run whose timed path or fly camera is broken
underneath comes out not correct, and the roofline counts follow from
shapes."""

from __future__ import annotations

import tempfile

import numpy as np
import pytest

from portbench import check, roofline
from portbench.program import Session
from portbench.tests.cells import rehearse, tiny


def _walk(workload, seed, calls=10, scene=None):
    """A tiny cell's session after `calls` render calls along a short
    walk: (cfg, session, the frame each call returned, tmpdir)."""
    _, _, cfg, _ = tiny(workload)
    tmp = tempfile.mkdtemp()
    cfg["assets_seed"] = seed
    if scene is not None:
        cfg["scene"] = scene
    s = Session(cfg, "cpu", tmp)
    t = 1000.0
    s.io.update(t)
    s.apply((0.0, "keydown", "KeyD"), t)
    frames = []
    for i in range(calls):
        t += 40.0
        if i == 4:
            s.apply((0.0, "mouse", 40.0, -15.0), t)
        s.io.update(t)
        frames.append(s.render_frame_u8())
    return cfg, s, frames, tmp


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 9])
def test_reference_agrees_with_the_program_at_24px(seed):
    cfg, s, frames, tmp = _walk("theater-1080p-viewer", seed)
    pairs = [(s.frame_of_call(c), frames[c]) for c in (len(frames) - 1, len(frames) - 3)]
    got = check.compare(cfg, "cpu", tmp, s.record(), pairs)
    assert got["readings"] == [0.0, 0.0]
    # the walk moved the camera, and the replayed fly camera follows it
    assert got["poses_off"] == 0 and got["poses"] == s.poses
    assert len(set(s.poses)) == len(s.poses)
    # the control, bfloat16 in place of float32, fails the number compared:
    # the largest share off of the frames compared
    control = check.compare(cfg, "cpu", tmp, s.record(), pairs, precision="bfloat16")
    assert max(control["readings"]) > cfg["check"]["limit_values_off_pct"], control


@pytest.mark.parametrize("scene", ["cornell", "wave"])
def test_a_scene_file_agrees_on_both_sides_at_24px(scene):
    """A scene that no cell runs yet: its file alone lets both sides build
    it, and the reference (the wave's pillars moved every frame) agrees."""
    cfg, s, frames, tmp = _walk("theater-1080p-viewer", 1, calls=8, scene=scene)
    pairs = [(s.frame_of_call(c), frames[c]) for c in (5, 7)]
    got = check.compare(cfg, "cpu", tmp, s.record(), pairs)
    assert got["readings"] == [0.0, 0.0] and got["poses_off"] == 0


def test_dragon_reference_agrees_with_the_program_at_24px():
    cfg, s, frames, tmp = _walk("dragon-1080p-viewer", 3, calls=8)
    got = check.compare(cfg, "cpu", tmp, s.record(), [(s.frame_of_call(7), frames[7])],
                        count=True)
    assert got["readings"] == [0.0] and got["poses_off"] == 0
    assert got["passes"] == 4 and got["shape"]["triangles"] == 44_890
    # the sparse frame casts 5 closest hits and 5 shadows (PERF.md §6)
    counts = got["counts"]
    assert len(counts["closest_live"]) == 4 * 5 and len(counts["any_live"]) == 4 * 5


FAULTS = {
    # a step that returns its state unchanged: the frame of the call before
    "stale_frame": lambda prev, frame: prev if prev is not None else frame,
    # half of the batch left out: the lower half of the rows never rendered
    "half_rows": lambda prev, frame: np.concatenate(
        [frame[: frame.shape[0] // 2], np.zeros_like(frame[frame.shape[0] // 2:])]),
    # an answer altered where it is produced: one row of the frame off by one
    "one_row_off": lambda prev, frame: np.concatenate(
        [frame[:3], (frame[3:4].astype(np.int16) + 1).clip(0, 255).astype(np.uint8),
         frame[4:]]),
}


@pytest.mark.parametrize("workload", ["theater-1080p-viewer", "theater-1080p-served"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    """The whole run, the card's check skipped, with the program's
    render_frame_u8 broken underneath; the exchange between chips has no
    fault to plant: every cell runs on one chip."""
    from flexlight_tpu_torch.models.pathtracer import PathTracer

    original = PathTracer.render_frame_u8
    last = {}

    def broken(self):
        frame = original(self)
        out = FAULTS[fault](last.get("frame"), frame)
        last["frame"] = frame
        return out

    monkeypatch.setattr(PathTracer, "render_frame_u8", broken)
    res = rehearse(workload, seconds=2.0)
    assert res["correct"] is False
    assert res["failed"] >= 1


@pytest.mark.parametrize("workload", ["theater-1080p-viewer", "theater-1080p-served"])
def test_a_broken_fly_camera_is_not_correct(monkeypatch, workload):
    """The whole run with the program's WebIo integrating held keys at
    twice their speed: the poses replayed by the reference differ from
    the program's, and the frames rendered from them differ too."""
    from flexlight_tpu_torch.interaction import WebIo

    original = WebIo.update

    def broken(self, now_ms=None):
        saved = self._saved_time
        original(self, now_ms)
        self._saved_time = saved
        original(self, now_ms)

    monkeypatch.setattr(WebIo, "update", broken)
    res = rehearse(workload, seconds=2.0)
    assert res["correct"] is False
    assert res["checks"]["poses_off"]["value"] >= 1


def test_roofline_counts_follow_from_shapes():
    counts = roofline.per_frame({"closest_live": [100, 50], "closest_hits": [80, 20],
                                 "any_live": [60]}, frames=1)
    assert counts == {"closest_live": 150, "closest_hits": 100, "any_live": 60,
                      "closest_casts": 2, "any_casts": 1}
    shape = {"pixels": 1000, "triangles": 20, "lights": 9, "texture_bytes": 3000}
    # bytes: 150 rays x (28 + 16) + 60 x (28 + 1) + 3 casts x 20 x 64
    cast_bytes = 150 * 44 + 60 * 29 + 3 * 20 * 64
    assert roofline.casts_bytes(counts, 20) == cast_bytes
    ops_tests = 210 * 72
    assert roofline.tests_ops(counts) == ops_tests
    assert roofline.sparse_bound_ms(counts, shape) == pytest.approx(
        max(cast_bytes / 3.35e12, ops_tests / 67e12) * 1e3)
    fused_bytes = cast_bytes + 3000 + 1000 * 72
    fused_ops = ops_tests + 100 * (181 + 9 * 148)
    assert roofline.fused_bound_ms(counts, shape) == pytest.approx(
        max(fused_bytes / 3.35e12, fused_ops / 67e12) * 1e3)
    # at 1080p theater's bound is the bytes': 2 M primaries alone
    big = roofline.per_frame({"closest_live": [2_073_600], "closest_hits": [2_000_000],
                              "any_live": [2_000_000]}, frames=1)
    shape["pixels"] = 2_073_600
    assert roofline.fused_bound_ms(big, shape) > 0.05


def test_control_readings_at_a_tiny_size():
    """control.py's readings, as on the card: the program reads 0 and the
    bfloat16 control fails the limit."""
    import torch

    from portbench import control
    from portbench.tests.cells import tiny

    _, _, cfg, mix = tiny("theater-1080p-viewer")
    row = control.readings(cfg, mix, 2 ** 31 + 21, 1.5, torch.device("cpu"))
    assert row["program"] == 0.0
    assert row["control"] > cfg["check"]["limit_values_off_pct"]
