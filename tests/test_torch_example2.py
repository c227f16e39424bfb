"""The many-lights stress scene (examples/example2.js) in the port and in
the benchmark: `scenes.example2` built from the port's classes flattens
to the buffers of examples/example2.py built with flexlight_tpu's, before
and after its animation; through the benchmark's own session
(portbench.program.Session) at 24x16 with the pipelined fetch 4 deep,
every delivered frame along a short walk equals the frame of the plain
reference that rebuilds the scene every frame
(portbench/reference/renderers/pathtracer_animated.py), and the bfloat16
control fails the configuration's limit; under a profiler the scene's
rebuild is the span fl.scene.update, which the benchmark's scene metrics
read; and the route loads nothing of JAX."""

import importlib
import os
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

jax = pytest.importorskip("jax")

import flexlight_tpu as jpkg  # noqa: E402
from flexlight_tpu.ops import buffers as jbuf  # noqa: E402
from flexlight_tpu.scene import transform as jtransform  # noqa: E402
from flexlight_tpu_torch import reset_global_registry, scenes  # noqa: E402
from flexlight_tpu_torch.ops import buffers as tbuf  # noqa: E402
from flexlight_tpu_torch.utils import timing  # noqa: E402
from portbench import check, spec  # noqa: E402
from portbench.program import Session  # noqa: E402
from portbench.tests.cells import tiny  # noqa: E402
from tests.test_torch_scene_copy import EXAMPLES, assert_same_buffers  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "example2-1080p-viewer"


def _jax_example():
    """examples/example2.py:build_scene on flexlight_tpu's FlexLight:
    (engine, animate)."""
    jtransform.reset_global_registry()
    sys.path.insert(0, EXAMPLES)
    try:
        module = importlib.import_module("example2")
    finally:
        sys.path.remove(EXAMPLES)
    return module.build_scene()


@pytest.mark.parametrize("calls", [0, 1, 3])
def test_example2_flattens_as_the_jax_example(calls):
    """After `calls` animation steps both packages' scenes flatten to
    identical buffers, and the port's renderer holds them (its
    update_scene ran in the animation): 63 lights at the start, 64 once
    slot 1 is filled."""
    jengine, janimate = _jax_example()
    reset_global_registry()
    tengine, tanimate = scenes.example2(device="cpu")
    for call in range(calls):
        janimate(call)
        tanimate(call)
    jb = jbuf.build_scene_buffers(jengine.scene)
    tb = tbuf.build_scene_buffers(tengine.scene, "cpu")
    assert_same_buffers(jb, tb)
    assert tb.id_buffer.shape[0] == 62
    assert tb.lights.shape[0] == (64 if calls else 63)
    if calls:
        held = tengine.renderer._buffers
        for field in ("geometry", "attributes", "lights"):
            assert torch.equal(getattr(held, field), getattr(tb, field)), field


def _walk(tmp_path, calls=9, max_reflections=None):
    """The tiny cell's session after `calls` render calls along a walk with
    a held key and a drag: (cfg, session, the frame each call returned)."""
    _, _, cfg, _ = tiny(CELL)
    if max_reflections is not None:
        cfg["config"]["max_reflections"] = max_reflections
    s = Session(cfg, "cpu", str(tmp_path))
    t = 1000.0
    s.io.update(t)
    s.apply((0.0, "keydown", "KeyD"), t)
    frames = []
    for i in range(calls):
        t += 40.0
        if i == 4:
            s.apply((0.0, "mouse", 25.0, -10.0), t)
        s.io.update(t)
        frames.append(s.render_frame_u8())
    return cfg, s, frames


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_example2_frames_against_the_reference(tmp_path, precision):
    """float32: every frame the pipelined session delivered is the
    reference's, pose for pose (the scene moved between every two frames);
    bfloat16, the control: the largest share off exceeds the limit."""
    cfg, s, frames = _walk(tmp_path)
    assert s.scheme() == "fused_split" and s.depth == 4
    assert len(set(s.poses)) == len(s.poses)
    delivered = {s.frame_of_call(c): frames[c] for c in range(len(frames))}
    assert sorted(delivered) == [0, 1, 2, 3, 4]
    if precision == "bfloat16":
        delivered = {f: delivered[f] for f in (1, 3)}
    got = check.compare(cfg, "cpu", str(tmp_path), s.record(), sorted(delivered.items()),
                        precision=precision)
    assert got["poses_off"] == 0 and got["poses"] == s.poses
    assert got["shape"]["lights"] == 64 and got["shape"]["triangles"] == 62
    if precision == "float32":
        assert got["readings"] == [0.0] * 5
    else:
        assert max(got["readings"]) > cfg["check"]["limit_values_off_pct"], got["readings"]


def test_scene_update_span_and_its_metrics(tmp_path):
    """Each animation step is one fl.scene.update {triangles, lights,
    bytes, copies} outside fl.frame; the benchmark's scene_update_ms and
    scene_upload_mb read those spans over the frames."""
    cfg, s, _ = _walk(tmp_path, calls=1, max_reflections=1)
    timing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        s.warm_up(2)
    spans = timing.recorded()
    try:
        updates = [x for x in spans if x.name == "fl.scene.update"]
        frames = [x for x in spans if x.name == "fl.frame"]
        assert len(updates) == len(frames) == 2
        b = s.renderer._buffers
        tensors = [t for f in b for t in (f if isinstance(f, tbuf.AtlasTable) else (f,))]
        nbytes = sum(t.nbytes for t in tensors)
        for update in updates:
            assert update.parent is None and update.trace not in {f.trace for f in frames}
            assert update.attrs == {"triangles": 62, "lights": 64, "bytes": nbytes,
                                    "copies": 20}
        assert len(tensors) == 20
        ms = spec.metric_reader("scene_update_ms")(None)
        want = sum(u.end_ns - u.start_ns for u in updates) / 1e6 / 2
        assert ms == pytest.approx(want) and ms > 0.0
        assert spec.metric_reader("scene_upload_mb")(None) == pytest.approx(nbytes / 1e6)
    finally:
        timing.reset()


def test_example2_route_never_imports_jax():
    """The scene built from the port's classes, animated and rendered
    pipelined on the CPU, loads no module of jax and none of flexlight_tpu."""
    code = """
import sys
from flexlight_tpu_torch import Config, scenes
e, animate = scenes.example2(device="cpu")
e.canvas = (16, 12)
e.config = Config(temporal=True, temporal_samples=2, filter=True, antialiasing="fxaa",
                  max_reflections=1)
e.renderer = "pathtracer"
e.renderer.pipelined = 4
for call in range(3):
    animate(call)
    assert e.renderer.render_frame_u8().shape == (12, 16, 3)
assert e.renderer.resolved_scheme() == "fused_split"
assert e.renderer._buffers.lights.shape[0] == 64
print("jax" in sys.modules, sorted(m for m in sys.modules
                                   if m.split(".")[0] in ("jax", "jaxlib", "flexlight_tpu")))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "[]"]
