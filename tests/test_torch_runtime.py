"""The port's runtime utilities against flexlight_tpu's: utils.image (PNG
bytes), utils.glpack, utils.settings (files cross both packages),
utils.timing, utils.checkpoint (render state and scene cache cross both
packages) and utils.failover (tests/test_failover.py's cases on the
port, and the classification of torch's device errors).

Tolerances: PNG bytes, glpack values, settings, scene caches and loaded
state are identical. A frame rendered after a checkpoint crossed the
packages is held to tests/test_torch_render.py's golden budget for whole
frames (<= 1% of values over 2e-3, max <= 0.5), flexlight_tpu running op
by op with the counter RNG as there; within the port, a resumed frame is
identical to the uninterrupted one."""

import json
import os
import time

import numpy as np
import pytest
import torch

import flexlight_tpu_torch as port
from flexlight_tpu_torch.models.pathtracer import PathTracer
from flexlight_tpu_torch.utils import checkpoint as tck
from flexlight_tpu_torch.utils import glpack as tglpack
from flexlight_tpu_torch.utils import image as timage
from flexlight_tpu_torch.utils import settings as tsettings
from flexlight_tpu_torch.utils.failover import (DeviceLostError, FailoverRunner,
                                                _is_device_error, run_supervised)
from flexlight_tpu_torch.utils.timing import enable_nan_debugging, profile_trace, span

jax = pytest.importorskip("jax")

import flexlight_tpu as jpkg  # noqa: E402
from flexlight_tpu.utils import checkpoint as jck  # noqa: E402
from flexlight_tpu.utils import glpack as jglpack  # noqa: E402
from flexlight_tpu.utils import image as jimage  # noqa: E402
from flexlight_tpu.utils import settings as jsettings  # noqa: E402
from tests.scenes import cornell_config  # noqa: E402
from tests.test_torch_scene_copy import build  # noqa: E402

SIZE = 16


# ---- image, glpack ----------------------------------------------------------

@pytest.mark.parametrize("shape, level", [((24, 24, 3), 6), ((17, 5, 3), 1), ((1, 33, 3), 9)])
def test_png_bytes_are_identical(shape, level):
    rng = np.random.default_rng(sum(shape) + level)
    floats = rng.uniform(-0.2, 1.2, shape).astype(np.float32)
    u8 = rng.integers(0, 256, shape, dtype=np.uint8)
    for img in (floats, u8):
        assert timage.png_bytes(img, level=level) == jimage.png_bytes(img, level=level)
    np.testing.assert_array_equal(timage.to_uint8(floats), jimage.to_uint8(floats))


def test_write_png_is_identical(tmp_path):
    img = np.random.default_rng(3).uniform(0, 1, (9, 7, 3)).astype(np.float32)
    timage.write_png(str(tmp_path / "a.png"), img)
    jimage.write_png(str(tmp_path / "b.png"), img)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()


def test_glpack_is_identical():
    rng = np.random.default_rng(7)
    for x in list(rng.uniform(-255.0, 255.0, 64)) + [-255.0, 0.0, 254.99, 255.0]:
        np.testing.assert_array_equal(tglpack.to_bytes(x), jglpack.to_bytes(x))
        b = jglpack.to_bytes(x)
        assert tglpack.to_float(b) == jglpack.to_float(b)
    chans = rng.integers(0, 256, (32, 4))
    assert [tglpack.to_float(c) for c in chans] == [jglpack.to_float(c) for c in chans]
    vals = np.concatenate([rng.normal(0.0, 100.0, 64), [0.0, 65504.0, 6e-5, -6e-8]])
    vals = vals.astype(np.float32)
    bits = tglpack.float32_to_float16_bits(vals)
    np.testing.assert_array_equal(bits, jglpack.float32_to_float16_bits(vals))
    np.testing.assert_array_equal(tglpack.float16_bits_to_float32(bits),
                                  jglpack.float16_bits_to_float32(bits))


# ---- settings ----------------------------------------------------------------

def test_settings_cross_both_packages(tmp_path):
    kwargs = dict(samples_per_ray=2, filter=True, antialiasing="taa", render_quality=0.5,
                  filter_mode="compat", rng="counter")
    a, b = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    tsettings.save_settings(port.Config(**kwargs), renderer="pathtracer", api="webgl2", path=a)
    jsettings.save_settings(jpkg.Config(**kwargs), renderer="pathtracer", api="webgl2", path=b)
    assert open(a).read() == open(b).read()
    jcfg, jr, japi = jsettings.load_settings(a)
    tcfg, tr, tapi = tsettings.load_settings(b)
    assert jcfg == jpkg.Config(**kwargs) and tcfg == port.Config(**kwargs)
    assert (jr, japi) == (tr, tapi) == ("pathtracer", "webgl2")


def test_settings_defaults_unknown_fields_and_engine(tmp_path):
    assert tsettings.DEFAULT_PATH == os.path.expanduser("~/.flexlight_tpu_torch.json")
    loaded, renderer, api = tsettings.load_settings(str(tmp_path / "nope.json"))
    assert loaded == port.Config() and renderer is None and api is None
    path = tmp_path / "settings.json"
    path.write_text('{"config": {"filter": true, "bogus_knob": 9}, "renderer": "rasterizer"}')
    loaded, renderer, _ = tsettings.load_settings(str(path))
    assert loaded.filter is True and renderer == "rasterizer"
    path.write_text("not json")
    assert tsettings.load_settings(str(path)) == (port.Config(), None, None)
    tsettings.save_settings(port.Config(filter=True, temporal=False), renderer="rasterizer",
                            api="simple", path=str(path))
    engine = port.FlexLight((8, 8), device="cpu")
    tsettings.apply_settings(engine, str(path))
    assert engine.config.filter is True and engine.config.temporal is False
    assert engine.api == "simple" and type(engine.renderer).__name__ == "SimplePathTracer"


# ---- timing ------------------------------------------------------------------

def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "prof")):
        with span("fl.test"):
            torch.ones(64).cumsum(0)
    data = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any("cumsum" in ev.get("name", "") for ev in data["traceEvents"])
    assert any(ev.get("name") == "fl.test" for ev in data["traceEvents"])


def test_enable_nan_debugging():
    from flexlight_tpu_torch.utils import debug

    try:
        enable_nan_debugging()
        assert debug.debug_enabled()
        with pytest.raises(FloatingPointError):
            debug.assert_finite(torch.tensor([1.0, float("nan")]), "x")
    finally:
        debug.set_debug(False)


# ---- checkpoint ----------------------------------------------------------------

def _cfg(**kw):
    return cornell_config(temporal=True, temporal_samples=2, max_reflections=2,
                          rng="counter", **kw)


def _jax_tracer(cfg):
    from flexlight_tpu.models.pathtracer import PathTracer as JPathTracer

    scene, camera = build("cornell", jpkg)
    return JPathTracer(SIZE, SIZE, scene, camera, cfg, scheme="mxu")


def _port_tracer(cfg):
    scene, camera = build("cornell", port)
    return PathTracer(SIZE, SIZE, scene, camera, port.Config(**vars(cfg)), "cpu")


def _golden_budget(a, b):
    d = np.abs(a - b)
    assert (d > 2e-3).mean() <= 0.01 and d.max() <= 0.5


def test_checkpoint_crosses_both_packages(tmp_path):
    """tests/test_interaction.py's checkpoint setup (cornell 16x16,
    temporal 2, 2 bounces) after 2 frames, written by flexlight_tpu and
    loaded into the port, and the reverse: the loaded state is the
    written one, and the next frame matches the other package's next
    frame."""
    cfg = _cfg()
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jt, tt = _jax_tracer(cfg), _port_tracer(cfg)
    with jax.disable_jit():
        for _ in range(2):
            jt.render_frame()
        jck.save_render_state(jpath, jt)
        for _ in range(2):
            tt.render_frame()
        tck.save_render_state(tpath, tt)
        assert "taa_history" in np.load(jpath) and "taa_history" not in np.load(tpath)

        loaded = _port_tracer(cfg)
        loaded.render()
        tck.load_render_state(jpath, loaded)
        assert loaded._frame_count == 2 and loaded._taa_state is None
        fields = [getattr(loaded._temporal_state, k) for k in ("color", "ip", "ids", "oid")]
        assert len({t.data_ptr() for t in fields}) == 4   # no aliased ring
        for name, t in zip(("color", "ip", "ids", "oid"), fields):
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(getattr(jt._temporal_state, name)))
        jloaded = _jax_tracer(cfg)
        jloaded.render()
        jck.load_render_state(tpath, jloaded)
        assert jloaded._frame_count == 2

        j_next, t_next = jt.render_frame(), tt.render_frame()
        _golden_budget(loaded.render_frame(), j_next)
        _golden_budget(jloaded.render_frame(), t_next)


def test_taa_checkpoint_resumes_exactly(tmp_path):
    """Under TAA the port writes its history and a TAA renderer loads it;
    a renderer without TAA keeps none. The checkpoint carries no jitter
    index (nor does flexlight_tpu's), so the resumed renderer takes the
    uninterrupted one's before its next frame, which is then identical."""
    cfg = _cfg(antialiasing="taa")
    path = str(tmp_path / "taa.npz")
    a = _port_tracer(cfg)
    for _ in range(3):
        a.render_frame()
    tck.save_render_state(path, a)
    assert np.load(path)["taa_history"].shape == (9, SIZE, SIZE, 4)
    b = _port_tracer(cfg)
    tck.load_render_state(path, b)
    torch.testing.assert_close(b._taa_state.history, a._taa_state.history, rtol=0, atol=0)
    b._jitter.current = a._jitter.current
    np.testing.assert_array_equal(b.render_frame(), a.render_frame())
    c = _port_tracer(_cfg())
    tck.load_render_state(path, c)
    assert c._taa_state is None and c._frame_count == 3


def test_checkpoint_rejects_another_resolution(tmp_path):
    path = str(tmp_path / "s.npz")
    a = _port_tracer(_cfg())
    a.render_frame()
    tck.save_render_state(path, a)
    scene, camera = build("cornell", port)
    other = PathTracer(SIZE + 1, SIZE, scene, camera, a.config, "cpu")
    with pytest.raises(ValueError, match="resolution"):
        tck.load_render_state(path, other)


def test_scene_cache_crosses_both_packages(tmp_path):
    """Geometry and id buffer identical whichever package wrote the cache;
    the port's buffers carry the atlas tables of no texture and render."""
    from flexlight_tpu_torch.ops.buffers import build_atlas_table
    from flexlight_tpu_torch.ops.pathtrace import render_mrt

    jscene, _ = build("cornell", jpkg)
    built = jscene.generate_arrays()
    jck.save_scene_cache(str(tmp_path / "jax.npz"), jscene)
    tscene, tcamera = build("cornell", port)
    tck.save_scene_cache(str(tmp_path / "port.npz"), tscene)
    for name in ("jax", "port"):
        tb = tck.load_scene_cache(str(tmp_path / f"{name}.npz"), "cpu")
        jb = jck.load_scene_cache(str(tmp_path / f"{name}.npz"))
        for field in ("geometry", "id_buffer", "attributes", "lights", "ambient"):
            np.testing.assert_array_equal(getattr(tb, field).numpy(),
                                          np.asarray(getattr(jb, field)))
        np.testing.assert_array_equal(tb.geometry.numpy(), built.geometry)
        np.testing.assert_array_equal(tb.id_buffer.numpy(), built.id_buffer)
        empty = build_atlas_table([], (1, 1), "cpu")
        for tab in (tb.albedo_tab, tb.pbr_tab, tb.tpo_tab):
            for x, y in zip(tab, empty):
                assert torch.equal(x, y)
    mrt = render_mrt(tb, 8, 8, tcamera.position, tcamera.view_matrix(8, 8),
                     port.Config(max_reflections=1), 0.0, scheme="fused_split")
    assert torch.isfinite(mrt.color).all() and float(mrt.alpha.sum()) > 0


# ---- failover ----------------------------------------------------------------

class _XlaRuntimeError(RuntimeError):
    """A name with 'Runtime' in it classifies as device loss."""


class AcceleratorError(Exception):
    """torch.AcceleratorError's name on a type of its own: device loss."""


class _StubRenderer:
    """Minimal duck-type for FailoverRunner: script per-frame behavior."""

    def __init__(self, script):
        self.script = list(script)
        self.config = port.Config()
        self.width = self.height = 4
        self._frame_count = 0
        self._temporal_state = None
        self._taa_state = None

    def render_frame(self):
        action = self.script.pop(0)
        if action == "hang":
            time.sleep(30.0)
        if isinstance(action, BaseException):
            raise action
        self._frame_count += 1
        return np.zeros((4, 4, 3), np.float32)


def test_hang_detected_within_timeout(tmp_path):
    r = _StubRenderer(["ok", "hang"])
    runner = FailoverRunner(r, str(tmp_path / "s.npz"), mirror_every=1, timeout_s=0.3)
    runner.step()
    t0 = time.perf_counter()
    with pytest.raises(DeviceLostError) as e:
        runner.step()
    assert time.perf_counter() - t0 < 5.0
    assert e.value.checkpoint_path == str(tmp_path / "s.npz")


@pytest.mark.parametrize("err", [_XlaRuntimeError("DEADLINE_EXCEEDED"),
                                 RuntimeError("CUDA error: an illegal memory access"),
                                 AcceleratorError("CUDA error: unspecified launch failure")])
def test_device_error_classified_and_checkpointed(tmp_path, err):
    r = _StubRenderer(["ok", err])
    runner = FailoverRunner(r, str(tmp_path / "s.npz"), mirror_every=1, timeout_s=10.0)
    runner.step()
    with pytest.raises(DeviceLostError):
        runner.step()
    assert (tmp_path / "s.npz").exists()


@pytest.mark.parametrize("err", [ValueError("bug"), torch.OutOfMemoryError("out of memory"),
                                 MemoryError("host"), FloatingPointError("nan")])
def test_other_errors_propagate_unchanged(tmp_path, err):
    r = _StubRenderer([err])
    runner = FailoverRunner(r, str(tmp_path / "s.npz"), timeout_s=10.0)
    with pytest.raises(type(err)):
        runner.step()
    assert not (tmp_path / "s.npz").exists()


def test_error_classification():
    assert _is_device_error(AcceleratorError("x")) and _is_device_error(OSError("x"))
    if hasattr(torch, "AcceleratorError"):
        assert _is_device_error(torch.AcceleratorError("CUDA error"))
    assert not _is_device_error(torch.OutOfMemoryError("x"))
    assert not _is_device_error(TypeError("x"))


def test_no_mirror_means_no_checkpoint(tmp_path):
    r = _StubRenderer([_XlaRuntimeError("boom")])
    runner = FailoverRunner(r, str(tmp_path / "s.npz"), timeout_s=10.0)
    with pytest.raises(DeviceLostError) as e:
        runner.step()
    assert e.value.checkpoint_path is None
    assert not (tmp_path / "s.npz").exists()


def _raise_runtime():
    raise _XlaRuntimeError("device gone")


def test_mirror_resume_roundtrip(tmp_path):
    """A real renderer: fail after the mirror, resume in a fresh renderer:
    the state is the mirrored frame's, and the resumed renderer's next
    frame is the frame after the mirror."""
    path = str(tmp_path / "state.npz")
    pt = _port_tracer(_cfg())
    runner = FailoverRunner(pt, path, mirror_every=2, timeout_s=60.0)
    runner.step()
    runner.step()   # mirror refreshed here (mirror_every=2)
    mirrored_count = pt._frame_count
    mirrored_temporal = pt._temporal_state.color.clone()
    after_mirror = runner.step()   # lost on failure, by design
    pt.render_frame = _raise_runtime
    with pytest.raises(DeviceLostError):
        runner.step()
    pt2 = _port_tracer(_cfg())
    runner2 = FailoverRunner(pt2, path)
    assert runner2.resume()
    assert pt2._frame_count == mirrored_count
    assert torch.equal(pt2._temporal_state.color, mirrored_temporal)
    np.testing.assert_array_equal(runner2.step(), after_mirror)


def test_run_supervised_completes_and_checkpoints(tmp_path):
    path = str(tmp_path / "state.npz")
    n = run_supervised(_port_tracer(_cfg()), path, frames=3, mirror_every=2, timeout_s=60.0)
    assert n == 3 and (tmp_path / "state.npz").exists()
    pt2 = _port_tracer(_cfg())
    assert FailoverRunner(pt2, path).resume()
    assert pt2._frame_count == 3
    assert not FailoverRunner(_port_tracer(_cfg()), str(tmp_path / "none.npz")).resume()
