"""The port's frame server (flexlight_tpu_torch.serve) and the path
tracer's pipelined fetch (PathTracer.pipelined).

The server's cases are tests/test_serve.py's, on the port's tiny 24x24
engine on the CPU: viewer page, PNG frames, key / mouse input routed into
the WebIo fly camera, stats, live config, the renderer hot swap.

The pipelined fetch returns frame N-k with the warm-up rule of
flexlight_tpu (frame 0 for the first k + 1 calls, then 1, 2, ...; a
lowered depth drains at once). The camera moves every frame (the light's
intensity changes, in the comparison with flexlight_tpu), so every frame
differs from the others and a returned frame names its index by being
identical to one synchronous frame. Against flexlight_tpu (run op
by op, as tests/test_torch_render.py runs it) the index pattern must be
the same and each frame within that file's golden budget for whole
frames (<= 1% of values over 2e-3, max <= 0.5)."""

import json
import struct
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import flexlight_tpu_torch as port
from flexlight_tpu_torch.models.pathtracer import PathTracer
from flexlight_tpu_torch.serve import FrameServer
from flexlight_tpu_torch.utils import timing


def _tiny_engine():
    engine = port.FlexLight((24, 24), device="cpu")
    scene, camera = engine.scene, engine.camera
    scene.primaryLightSources = [[0, 4, 0]]
    scene.primary_light_sources[0].intensity = 100
    plane = scene.Plane([-5, -1, -5], [5, -1, -5], [5, -1, 5], [-5, -1, 5])
    scene.queue.push(plane)
    camera.y, camera.z = 2, -6
    engine.config = engine.config.replace(
        temporal=False, filter=False, antialiasing=None, max_reflections=2,
        samples_per_ray=1)
    engine.renderer = "pathtracer"
    return engine


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status


def decode_png(data: bytes) -> np.ndarray:
    """[H, W, 3] uint8 of a PNG that utils.image.png_bytes wrote (one IDAT,
    filter 0 on every row)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


@pytest.fixture(scope="module")
def server():
    srv = FrameServer(_tiny_engine())
    url = srv.start()
    assert srv.wait_for_frame(1, timeout=120.0)
    yield srv, url
    srv.stop()


def test_viewer_page(server):
    _, url = server
    status, ctype, body = _get(url)
    assert status == 200 and ctype.startswith("text/html")
    assert b"/frame.png" in body and b"keydown" in body


def test_frame_png(server):
    _, url = server
    status, ctype, body = _get(url + "frame.png")
    assert status == 200 and ctype == "image/png"
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", body[16:24])
    assert (w, h) == (24, 24)
    assert decode_png(body).shape == (24, 24, 3)


def test_key_input_moves_camera(server):
    srv, url = server
    cam = srv.engine.camera
    z0 = cam.z
    assert _post(url + "input", {"type": "keydown", "code": "KeyW"}) == 200
    seq = srv._seq
    assert srv.wait_for_frame(seq + 3)   # a few frames of integration
    assert _post(url + "input", {"type": "keyup", "code": "KeyW"}) == 200
    assert cam.z > z0   # moved forward (camera faces +z at fx=0)


def test_mouse_look(server):
    srv, url = server
    cam = srv.engine.camera
    fx0 = cam.fx
    assert _post(url + "input", {"type": "mouse", "dx": 40, "dy": 0}) == 200
    assert cam.fx != fx0


def test_stats(server):
    srv, url = server
    status, _, body = _get(url + "stats")
    assert status == 200
    stats = json.loads(body)
    assert stats["frames"] >= 1
    assert "fps" in stats
    assert stats["last"]["scheme"] == "fused_split"
    assert srv.engine.renderer.pipelined == 4   # the render loop's swapchain depth


def test_config_endpoint_reads_knobs(server):
    _, url = server
    status, ctype, body = _get(url + "config")
    assert status == 200 and ctype == "application/json"
    cfg = json.loads(body)
    assert cfg["renderer"] == "pathtracer"
    assert cfg["filter"] is False and cfg["max_reflections"] == 2
    assert cfg["filter_mode"] in ("fast", "compat")


def test_config_mutation_applies_live(server):
    """POST /config mutates quality knobs mid-run and the renderer
    re-prepares — the reference's parameterForm flow (loader.js:65-93)."""
    srv, url = server
    assert _post(url + "config", {"max_reflections": 1, "min_importancy": 0.5}) == 200
    seq = srv._seq
    assert srv.wait_for_frame(seq + 2, timeout=120.0)
    assert srv.engine.config.max_reflections == 1
    assert srv.engine.config.min_importancy == 0.5
    status, _, body = _get(url + "config")
    assert json.loads(body)["max_reflections"] == 1
    # restore (module-scoped engine)
    assert _post(url + "config", {"max_reflections": 2, "min_importancy": 0.3}) == 200
    seq = srv._seq
    assert srv.wait_for_frame(seq + 2, timeout=120.0)


def test_config_validation(server):
    """Knobs are coerced as flexlight_tpu's server coerces them; unknown
    keys are dropped."""
    srv, _ = server
    accepted = srv.queue_config({"antialiasing": "msaa", "filter_mode": "x",
                                 "first_passes": -2, "samples_per_ray": 0,
                                 "temporal": 1, "bogus": 3, "renderer": 7})
    assert accepted == {"antialiasing": None, "filter_mode": "fast", "first_passes": 0,
                        "samples_per_ray": 1, "temporal": True}
    with srv._lock:
        srv._pending_config = {}


def test_config_renderer_hot_swap(server):
    srv, url = server
    assert _post(url + "config", {"renderer": "rasterizer"}) == 200
    seq = srv._seq
    assert srv.wait_for_frame(seq + 2, timeout=120.0)
    assert srv.engine.renderer.type == "rasterizer"
    status, _, body = _get(url + "frame.png")
    assert status == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
    assert _post(url + "config", {"renderer": "pathtracer"}) == 200
    seq = srv._seq
    assert srv.wait_for_frame(seq + 2, timeout=120.0)
    assert srv.engine.renderer.type == "pathtracer"


def test_frozen_frame_is_served(server):
    """With `freeze` the render loop serves the renderer's last frame: the
    PNG decodes to exactly that uint8 frame."""
    srv, url = server
    renderer = srv.engine.renderer
    renderer.freeze = True
    try:
        seq = srv._seq
        assert srv.wait_for_frame(seq + 2)
        _, _, body = _get(url + "frame.png")
        np.testing.assert_array_equal(decode_png(body), renderer._last_frame)
    finally:
        renderer.freeze = False


def test_bad_input_rejected(server):
    _, url = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "input", {"type": "nope"})
    assert e.value.code == 400


def test_frame_seq_header_and_served_counters(server):
    """/frame.png names its frame (X-Frame-Seq); traced, the render thread
    keeps fl.serve.encode {seq} beside its frames (fl.frame), and a
    handler keeps fl.serve.send {seq} of the frame it sent: the seqs that
    portbench/metrics/served_share.py counts."""
    srv, url = server
    timing.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            assert srv.wait_for_frame(srv._seq + 2)
            seqs = []
            for _ in range(2):
                with urllib.request.urlopen(url + "frame.png", timeout=30) as r:
                    seqs.append(int(r.headers["X-Frame-Seq"]))
                    r.read()
            assert srv.wait_for_frame(seqs[-1] + 1)
        spans = timing.recorded()
    finally:
        timing.reset()
    assert 1 <= seqs[0] <= seqs[1] <= srv._seq
    encodes = [s for s in spans if s.name == "fl.serve.encode"]
    sends = [s for s in spans if s.name == "fl.serve.send"]
    frames = [s for s in spans if s.name == "fl.frame"]
    assert encodes and {s.thread for s in encodes} == {"flexlight-render"}
    assert frames and {s.thread for s in frames} == {"flexlight-render"}
    assert all(s.parent is None for s in encodes + frames)
    assert [s.attrs["seq"] for s in sends] == seqs
    assert all(s.thread != "flexlight-render" for s in sends)
    encoded = [s.attrs["seq"] for s in encodes]
    assert encoded == sorted(set(encoded))          # one encode a frame, in order
    # the first frame waited for began its encode after the profiler started
    assert set(seqs) <= set(encoded)


def test_stop_joins_the_threads():
    srv = FrameServer(_tiny_engine())
    srv.start()
    assert srv.wait_for_frame(1, timeout=120.0)
    srv.stop()
    assert not any(t.is_alive() for t in srv._threads)


# --------------------------------------------------------------------------
# the pipelined fetch
# --------------------------------------------------------------------------

def _cornell_tracer():
    from flexlight_tpu_torch.scene.transform import reset_global_registry
    from flexlight_tpu_torch.scenes import cornell

    reset_global_registry()
    e = cornell((16, 16), device="cpu")
    cfg = port.Config(temporal=True, temporal_samples=2, filter=False, antialiasing=None,
                      max_reflections=2, rng="counter")
    return PathTracer(16, 16, e.scene, e.camera, cfg, "cpu")


def run_frames(tracer, depths, u8=False, vary="camera"):
    """One frame per entry of `depths`, rendered with that `pipelined`
    depth; before each the camera moves (vary="camera") or the light's
    intensity changes (vary="light"). The returned frames."""
    x0 = tracer.camera.x
    light = tracer.scene.primary_light_sources[0]
    frames = []
    for i, depth in enumerate(depths):
        tracer.pipelined = depth
        if vary == "camera":
            tracer.camera.x = x0 + 0.4 * i
        else:
            light.intensity = 160 + 40 * i
            tracer.update_primary_light_sources()
        frames.append(tracer.render_frame_u8() if u8 else tracer.render_frame())
    return frames


def frame_indices(frames, sync):
    """For each frame, the index of the synchronous frame it is
    identical to (None if none)."""
    out = []
    for f in frames:
        hits = [j for j, s in enumerate(sync) if np.array_equal(f, s)]
        out.append(hits[0] if hits else None)
    return out


@pytest.fixture(scope="module")
def sync_u8():
    """The first 8 synchronous uint8 frames, each unlike the others."""
    sync = run_frames(_cornell_tracer(), [0] * 8, u8=True)
    assert all(not np.array_equal(a, b) for i, a in enumerate(sync) for b in sync[i + 1:])
    return sync


@pytest.mark.parametrize("depths, expect", [
    ([1] * 6, [0, 0, 1, 2, 3, 4]),
    ([2] * 6, [0, 0, 0, 1, 2, 3]),
    ([4] * 8, [0, 0, 0, 0, 0, 1, 2, 3]),
    ([True] * 4, [0, 0, 1, 2]),
    # a lowered depth drains the queue at once
    ([4] * 6 + [1] * 2, [0, 0, 0, 0, 0, 1, 5, 6]),
    ([2] * 4 + [0] * 2, [0, 0, 0, 1, 4, 5]),
])
def test_pipelined_frames_are_the_synchronous_frames(sync_u8, depths, expect):
    frames = run_frames(_cornell_tracer(), depths, u8=True)
    # every array is compared after the last call: no later copy overwrote it
    assert frame_indices(frames, sync_u8) == expect


def test_pipelined_queue_resets_with_the_shape_and_freeze_holds():
    tracer = _cornell_tracer()
    run_frames(tracer, [2] * 3)
    assert len(tracer._pending_display) == 2
    tracer.config = tracer.config.replace(max_reflections=1)
    tracer.render_frame()
    assert len(tracer._pending_display) == 1 and tracer._frame_count == 1
    tracer.freeze = True
    last = tracer._last_frame
    assert tracer.render_frame() is last and tracer._frame_count == 1


def test_pipelined_index_pattern_matches_flexlight_tpu():
    """flexlight_tpu's PathTracer.pipelined and the port's on the same
    16x16 cornell scene, counter RNG, depth 2 then lowered to 1: the port's
    frames are its synchronous frames in the order [0, 0, 0, 1, 2, 4, 5],
    and flexlight_tpu's frame of each call is nearest to, and within the
    golden budget of, the port's synchronous frame of the same index.
    Here the light's intensity tells the frames apart and the camera
    stays: the casts are then those of the view that
    tests/test_torch_render.py holds, while a moved camera puts some of
    cornell's quad diagonals on the knife edges that the two packages'
    casts may decide apart (tests/test_torch_traverse.py
    `knife_edge_rays`), which is not what this test is about."""
    jax = pytest.importorskip("jax")
    import flexlight_tpu as jpkg
    from tests.scenes import cornell_config
    from tests.test_torch_scene_copy import build

    cfg = cornell_config(temporal=True, temporal_samples=2, max_reflections=2, rng="counter")
    depths = [2] * 5 + [1] * 2
    expect = [0, 0, 0, 1, 2, 4, 5]

    def tracer(pkg):
        scene, camera = build("cornell", pkg)
        if pkg is port:
            return PathTracer(16, 16, scene, camera, port.Config(**vars(cfg)), "cpu")
        from flexlight_tpu.models.pathtracer import PathTracer as JPathTracer

        return JPathTracer(16, 16, scene, camera, cfg, scheme="mxu")

    sync = run_frames(tracer(port), [0] * len(depths), vary="light")
    assert all(not np.array_equal(a, b) for i, a in enumerate(sync) for b in sync[i + 1:])
    assert frame_indices(run_frames(tracer(port), depths, vary="light"), sync) == expect
    with jax.disable_jit():
        jframes = run_frames(tracer(jpkg), depths, vary="light")
    for i, (f, j) in enumerate(zip(jframes, expect)):
        err = [float(np.abs(f - s).mean()) for s in sync]
        assert int(np.argmin(err)) == j, (i, err)
        d = np.abs(f - sync[j])
        assert (d > 2e-3).mean() <= 0.01 and d.max() <= 0.5, i
