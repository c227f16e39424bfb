"""The many-lights cell on the CPU (example2-1080p-viewer at 24x16): the
reference's at(frame) puts the frozen scene in the same state whatever
order the frames come in, its shape() is the scene of the frames it
renders (64 lights), the tiny cell is correct and its traced run reads
the two scene metrics, and they read None where the program keeps no
span fl.scene.update."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from portbench import check, run, spec
from portbench.reference.frozen.ops.buffers import build_scene_buffers
from portbench.tests.cells import tiny

CELL = "example2-1080p-viewer"


def _states(order):
    """The frozen scene's buffers after at(frame) for each frame of `order`."""
    _, _, cfg, _ = tiny(CELL)
    engine, at = spec.part("scenes", cfg["scene"]).build_reference(cfg, "cpu", "")
    out = {}
    for frame in order:
        at(frame)
        out[frame] = build_scene_buffers(engine.scene, "cpu")
    return out


def test_reference_state_is_the_same_out_of_order():
    ordered = _states([0, 1, 2, 3, 4, 5, 6])
    shuffled = _states([5, 2, 6, 0, 3, 1, 4, 2])
    for frame, want in ordered.items():
        got = shuffled[frame]
        for field in ("geometry", "attributes", "lights", "id_buffer"):
            assert torch.equal(getattr(got, field), getattr(want, field)), (frame, field)
    assert not torch.equal(ordered[0].geometry, ordered[6].geometry)
    assert not torch.equal(ordered[0].lights, ordered[6].lights)


def test_reference_shape_reports_the_rendered_scene():
    _, _, cfg, _ = tiny(CELL)
    engine, ref = check.reference(cfg, "cpu", "")
    assert type(ref).__module__.endswith("renderers.pathtracer_animated")
    assert ref.scheme == "fused_split"
    shape = ref.shape()
    assert shape["lights"] == 64 and shape["triangles"] == 62


def test_tiny_traced_cell_reports_the_scene_metrics():
    """No device on the CPU: of the cell's per-layer metrics those that
    read the program's spans report, the two scene metrics among them (two
    traced frames keep the CPU profiler short)."""
    bench, cell, cfg, mix = tiny(CELL)
    mix["trace_frames"] = 2
    res = run.run_cell(bench, cell, cfg, mix, 2 ** 31 + 11, 1.5, True, "cpu",
                       start=time.perf_counter())
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"scene_update_ms", "scene_upload_mb", "host_render_ms",
                                   "host_post_ms", "fetch_wait_ms"}
    assert res["metrics"]["scene_update_ms"]["value"] > 0.0
    assert 0.0 < res["metrics"]["scene_upload_mb"]["value"] < 1.0


@pytest.mark.parametrize("name", ["scene_update_ms", "scene_upload_mb"])
def test_scene_metrics_read_none_without_the_span(monkeypatch, name):
    """A program that keeps fl.frame but not fl.scene.update (a static
    scene, or the parent of these metrics) reads None, never 0."""
    from portbench import program_spans

    frame = SimpleNamespace(name="fl.frame", trace=1, start_ns=0, end_ns=10, attrs={})
    monkeypatch.setattr(program_spans, "recorded", lambda: [frame])
    assert spec.metric_reader(name)(None) is None
    monkeypatch.setattr(program_spans, "recorded", lambda: None)
    assert spec.metric_reader(name)(None) is None
    update = SimpleNamespace(name="fl.scene.update", trace=2, start_ns=0, end_ns=4_000_000,
                             attrs={"bytes": 3_000_000})
    monkeypatch.setattr(program_spans, "recorded", lambda: [frame, frame, update])
    assert spec.metric_reader(name)(None) == pytest.approx(2.0 if name.endswith("ms") else 1.5)
