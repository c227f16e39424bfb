"""The rasterizer against the benchmark's plain-PyTorch reference of it
(portbench/reference/renderers/rasterizer.py, over a frozen copy of
models/rasterizer.py), on the CPU at 24x16 through the benchmark's own
session (portbench.program.Session): theater with its 4 translucent
layers, along a short walk, frame for frame equal; the bfloat16 control
fails the configuration's limit; and, under a profiler, a frame's spans
are those the benchmark's rasterizer metrics read
(portbench/metrics/raster_*.py)."""

import pytest
from torch.profiler import ProfilerActivity, profile

from flexlight_tpu_torch.utils import timing
from portbench import check
from portbench.program import Session
from portbench.tests.cells import tiny

CELL = "rasterizer-theater-1080p-viewer"


def _walk(seed, tmp_path, calls=6):
    """The tiny cell's session, its stand-in assets from `seed`, after
    `calls` render calls along a walk with a held key and a drag: (cfg,
    session, the frame each call returned)."""
    _, _, cfg, _ = tiny(CELL)
    cfg["assets_seed"] = seed
    s = Session(cfg, "cpu", str(tmp_path))
    t = 1000.0
    s.io.update(t)
    s.apply((0.0, "keydown", "KeyW"), t)
    frames = []
    for i in range(calls):
        t += 40.0
        if i == 3:
            s.apply((0.0, "mouse", -30.0, 12.0), t)
        s.io.update(t)
        frames.append(s.render_frame_u8())
    return cfg, s, frames


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 9])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_rasterizer_frames_against_the_reference(tmp_path, seed, precision):
    """float32: the program's frames are the reference's, pose for pose;
    bfloat16, the control: the largest share off exceeds the limit."""
    cfg, s, frames = _walk(seed, tmp_path)
    assert s.scheme() == "kernel" and s.renderer.resolved_layers() == 4
    assert s.depth == 0 and len(set(s.poses)) == len(s.poses)
    pairs = [(s.frame_of_call(c), frames[c]) for c in (len(frames) - 1, 2)]
    got = check.compare(cfg, "cpu", str(tmp_path), s.record(), pairs, precision=precision)
    assert got["poses_off"] == 0 and got["poses"] == s.poses
    if precision == "float32":
        assert got["readings"] == [0.0, 0.0]
    else:
        assert max(got["readings"]) > cfg["check"]["limit_values_off_pct"], got["readings"]


@pytest.mark.parametrize("layers", [4, 2])
def test_each_frame_holds_the_raster_spans(tmp_path, layers):
    """One fl.raster {scheme, layers, shade} under each fl.frame (a CPU
    frame shades in the plain versions), and under it
    `layers` fl.raster.cast and fl.raster.shade spans (one a layer, in
    order), one fl.raster.blend and one fl.aa."""
    _, _, cfg, _ = tiny(CELL)
    s = Session(cfg, "cpu", str(tmp_path))
    s.renderer.layers = layers
    s.warm_up(1)
    timing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        s.warm_up(2)
    spans = timing.recorded()
    timing.reset()
    frames = [x for x in spans if x.name == "fl.frame"]
    assert len(frames) == 2
    for frame in frames:
        mine = [x for x in spans if x.trace == frame.trace and x is not frame]
        raster, = [x for x in mine if x.name == "fl.raster"]
        assert raster.parent == frame.id
        assert raster.attrs == {"scheme": "kernel", "layers": layers, "shade": "plain"}
        inner = [x for x in mine if x.parent == raster.id]
        for name in ("fl.raster.cast", "fl.raster.shade"):
            assert [x.attrs["layer"] for x in inner if x.name == name] == list(range(layers))
        assert sorted({x.name for x in inner}) == ["fl.aa", "fl.raster.blend",
                                                   "fl.raster.cast", "fl.raster.shade"]
        assert sum(x.name in ("fl.raster.blend", "fl.aa") for x in inner) == 2
        assert frame.start_ns <= raster.start_ns <= raster.end_ns <= frame.end_ns
        assert sum(x.end_ns - x.start_ns for x in inner) <= raster.end_ns - raster.start_ns
