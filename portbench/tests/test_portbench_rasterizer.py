"""The rasterizer's cell on the CPU (rasterizer-theater-1080p-viewer at
24x16): its rehearsal is correct and its traced run reads the rasterizer's
spans, a run whose render_frame_u8 is broken underneath is not correct,
the rasterizer's reference loads nothing of the program or of JAX, and
raster_cast_roofline reads the share the frame's casts give."""

from __future__ import annotations

import subprocess
import sys
from types import SimpleNamespace

import pytest

from portbench import roofline, spec
from portbench.tests.cells import rehearse
from portbench.tests.test_portbench_reference import FAULTS

CELL = "rasterizer-theater-1080p-viewer"


def test_tiny_rasterizer_cell_is_correct():
    res = rehearse(CELL, seconds=2.0)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 2
    assert set(res["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
    assert res["checks"]["frame_values_off_pct"]["value"] == 0.0
    assert res["checks"]["poses_off"]["value"] == 0


def test_tiny_traced_rasterizer_cell_reads_its_spans():
    """No device on the CPU: of the cell's per-layer metrics only the
    host spans of the rasterizer read."""
    res = rehearse(CELL, seconds=1.5, trace=True)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"raster_host_ms", "raster_shade_ms"}
    host = res["metrics"]["raster_host_ms"]["value"]
    assert 0.0 < res["metrics"]["raster_shade_ms"]["value"] < host


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_rasterizer_is_not_correct(monkeypatch, fault):
    from flexlight_tpu_torch.models.rasterizer import Rasterizer

    original = Rasterizer.render_frame_u8
    last = {}

    def broken(self):
        frame = original(self)
        out = FAULTS[fault](last.get("frame"), frame)
        last["frame"] = frame
        return out

    monkeypatch.setattr(Rasterizer, "render_frame_u8", broken)
    res = rehearse(CELL, seconds=2.0)
    assert res["correct"] is False
    assert res["failed"] >= 1


def test_rasterizer_reference_imports_nothing_of_the_program():
    code = ("import sys, tempfile; from portbench import check, spec\n"
            "bench = spec.load_benchmark()\n"
            f"cfg = spec.config(bench, spec.cell(bench, {CELL!r})['config'])\n"
            "cfg['width'], cfg['height'] = 12, 8\n"
            "engine, ref = check.reference(cfg, 'cpu', tempfile.mkdtemp())\n"
            "assert type(ref).__module__.endswith('renderers.rasterizer')\n"
            "with ref.counting() as counts:\n"
            "    ref.display_u8([(0.0, 1.0, 0.0, 0.0, 0.0)], [0])\n"
            "assert len(counts['closest_live']) == 4 and len(counts['any_live']) == 36\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'flexlight_tpu_torch', 'flexlight_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip() == "[]"


def test_raster_cast_roofline_on_a_made_up_trace():
    """A 1080p frame: 4 closest-hit casts and 36 any-hit casts of every
    pixel, 20 triangles; the casts take 3.0 ms of device time a frame."""
    rays = 1920 * 1080
    counts = {"closest_live": [rays] * 4, "closest_hits": [rays // 2] * 4,
              "any_live": [rays] * 36}
    kernels = {"void fl_closest_hit_kernel<...>": [40, 0.006],
               "void fl_any_hit_kernel<...>": [360, 0.024],
               "void fl_fxaa_kernel<...>": [10, 0.0004],
               "void at::native::elementwise_kernel<...>": [70000, 0.8]}
    trace = {"frames": 10, "wall_s": 1.0, "busy_s": 0.83, "kernels": kernels,
             "idle_gaps": []}
    shape = {"pixels": rays, "triangles": 20, "lights": 9, "texture_bytes": 786_432}
    read = spec.metric_reader("raster_cast_roofline")
    run = SimpleNamespace(trace=trace, counts=counts, passes=1, shape=shape)
    nbytes = 4 * rays * 44 + 36 * rays * 29 + 40 * 20 * 64
    assert roofline.casts_bytes(roofline.per_frame(counts, 1), 20) == nbytes
    assert read(run) == pytest.approx(100.0 * nbytes / 3.35e12 * 1e3 / 3.0)
    assert 24.0 < read(run) < 26.0
    # nothing to read: None, never 0
    for empty in (SimpleNamespace(trace=None, counts=counts, passes=1, shape=shape),
                  SimpleNamespace(trace=trace, counts=None, passes=0, shape=shape),
                  SimpleNamespace(trace={**trace, "kernels": {}}, counts=counts, passes=1,
                                  shape=shape)):
        assert read(empty) is None


@pytest.mark.parametrize("name", ["raster_host_ms", "raster_shade_ms"])
def test_raster_span_metrics_read_none_without_the_spans(monkeypatch, name):
    """A program that keeps fl.frame but not the rasterizer's spans (the
    parent of these metrics) reads None, never 0."""
    from portbench import program_spans

    frame = SimpleNamespace(name="fl.frame", trace=1, start_ns=0, end_ns=10)
    monkeypatch.setattr(program_spans, "recorded", lambda: [frame])
    assert spec.metric_reader(name)(None) is None
    monkeypatch.setattr(program_spans, "recorded", lambda: None)
    assert spec.metric_reader(name)(None) is None
