"""The port's rasterizer and simple renderer against flexlight_tpu's on the
same inputs (the JAX buffers carried across with buffers_from_numpy, the
same camera position and view matrix), and the engine's renderer routes.

raster_frame is held on each of its schemes against
flexlight_tpu's raster_frame on the same scheme (its kernel and sparse
casts in interpret mode, as its own tests run them): textured cornell
with antialiasing None, "fxaa" and "taa" (3 jittered frames), and the
three scenes of tests/test_rasterizer_layers.py at layers = 4.

Tolerances, with their reasons:
- AA off: 1e-5 on every pixel none of whose casts (the primary and
  continuation casts, and every light's shadow cast of every layer) is a
  knife edge (tests/test_torch_traverse.py `knife_edge_rays`): the two packages round the camera
  rays, the barycentrics and the BRDF's sums in other orders, ~1e-7. A
  tie pixel may take another triangle or another shadow verdict, and so
  any value.
- AA on: the AA input is the display quantized to rgba8, and an ~1e-7
  difference moves a value that sits on a rounding edge by one step
  (1/255); FXAA carries a step, or a tie pixel, along an edge into its
  neighbours, TAA into the average of 9. So the frame is held with the
  golden budget of its pixels (<= 1% of values over 2e-3, max <= 0.5),
  beside 1e-5 where neither AA input differs in a 5 x 5 neighbourhood
  and no cast is a tie.
- The golden tests/goldens/cornell_rasterizer_24.npz was rendered by the
  jitted JAX package; the rasterizer uses no random numbers, so the port
  holds it with the golden budget itself."""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import flexlight_tpu as jpkg  # noqa: E402
from flexlight_tpu.models import rasterizer as JR  # noqa: E402
from flexlight_tpu.models.simple import simple_frame as jsimple  # noqa: E402
from flexlight_tpu.ops import buffers as jbuf  # noqa: E402
from flexlight_tpu.post.taa import Jitter as JJitter  # noqa: E402
from flexlight_tpu.post.taa import TAAState as JTAA  # noqa: E402
import flexlight_tpu_torch as port  # noqa: E402
from flexlight_tpu_torch.models import rasterizer as R  # noqa: E402
from flexlight_tpu_torch.models.simple import SimplePathTracer, simple_frame  # noqa: E402
from flexlight_tpu_torch.ops.buffers import buffers_from_numpy  # noqa: E402
from flexlight_tpu_torch.ops.geometry import world_geometry  # noqa: E402
from flexlight_tpu_torch.ops.intersect import BIAS, POW32  # noqa: E402
from flexlight_tpu_torch.ops.intersect_kernel import build_w4  # noqa: E402
from flexlight_tpu_torch.post import chain  # noqa: E402
from flexlight_tpu_torch.post.taa import TAAState  # noqa: E402
from tests.scenes import cornell_scene  # noqa: E402
from tests.test_torch_traverse import knife_edge_rays  # noqa: E402

SIZE = 24
TILE = 64                     # packet tile: 576 rays = 9 packets
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "cornell_rasterizer_24.npz")


def _textured_cornell():
    """tests/test_rasterizer_parity.py's textured cornell: a PBR checker on
    the first cube."""
    scene, camera = cornell_scene()
    tile = np.zeros((128, 128, 3), dtype=np.float32)
    tile[:64, :64] = tile[64:, 64:] = [1, 0, 0.4]
    tile[:64, 64:] = tile[64:, :64] = [0.1, 1, 0]
    scene.pbr_textures.push(scene.texture_from_rme(tile.reshape(-1), 128, 128))
    scene.standardTextureSizes = [128, 128]
    scene.queue[0][1].textureNums = [-1, 0, -1]
    return scene, camera


def _layer_scene(order):
    """tests/test_rasterizer_layers.py's wall and glass pane."""
    scene = jpkg.Scene()
    scene.primaryLightSources = [[0, 0.5, 2.5]]
    scene.primary_light_sources[0].intensity = 20
    wall = scene.Plane([-4, -4, 5], [4, -4, 5], [4, 4, 5], [-4, 4, 5])
    wall.color = [200, 40, 40]
    glass = scene.Plane([-4, -4, 0], [4, -4, 0], [4, 4, 0], [-4, 4, 0])
    glass.color = [40, 200, 40]
    glass.translucency = 0.5
    scene.queue.push(*((wall, glass) if order == "wall_first" else (glass, wall)))
    camera = jpkg.Camera()
    camera.z = -5
    return scene, camera


SCENES = {"cornell": _textured_cornell, "wall_first": lambda: _layer_scene("wall_first"),
          "glass_first": lambda: _layer_scene("glass_first"), "opaque": cornell_scene}


def _buffers(name):
    scene, camera = SCENES[name]()
    jb = jbuf.build_scene_buffers(scene)
    return jb, buffers_from_numpy(jax.tree.map(np.asarray, jb), "cpu"), camera


@pytest.fixture
def recorded_casts(monkeypatch):
    """Every cast the port's raster_frame makes: (any_hit, origin, dir,
    max_len)."""
    casts = []
    real = R._casts

    def casts_fn(*args):
        traverse_fn, shadow_fn = real(*args)

        def traverse(o, d):
            casts.append((False, o, d, torch.full_like(o[:, 0], POW32)))
            return traverse_fn(o, d)

        def shadow(o, d, max_len):
            casts.append((True, o, d, max_len))
            return shadow_fn(o, d, max_len)

        return traverse, shadow

    monkeypatch.setattr(R, "_casts", casts_fn)
    return casts


def _tie_pixels(tb, casts):
    """bool [H, W]: a pixel one of whose casts is a knife edge."""
    w4, _ = build_w4(world_geometry(tb), tb.id_buffer)
    tie = torch.zeros(SIZE * SIZE, dtype=torch.bool)
    for any_hit, o, d, max_len in casts:
        soa = [tuple(x[:, c].contiguous() for c in range(3)) for x in (o, d)]
        tie |= knife_edge_rays(w4, *soa, max_len, -BIAS, any_hit)
    return tie.reshape(SIZE, SIZE).numpy()


def _frames(name, scheme, aa, layers, n_frames=1, kernels=R.KERNELS):
    """(port frames, flexlight_tpu frames, port buffers)."""
    jb, tb, camera = _buffers(name)
    cfg = jpkg.Config(temporal=False, filter=False, antialiasing=aa)
    tcfg = port.Config(**vars(cfg))
    jstate, tstate = JTAA.create(SIZE, SIZE), TAAState.create(SIZE, SIZE, "cpu")
    jitter = JJitter()
    got, ref = [], []
    for _ in range(n_frames):
        view = camera.view_matrix(SIZE, SIZE, jitter.next(SIZE, SIZE) if aa == "taa"
                                  else (0.0, 0.0))
        j, jstate = JR.raster_frame(jb, jnp.asarray(camera.position), jnp.asarray(view),
                                    jstate, width=SIZE, height=SIZE, config=cfg,
                                    scheme=scheme, tile=TILE, layers=layers)
        t, tstate = R.raster_frame(tb, camera.position, view, tstate, SIZE, SIZE, tcfg,
                                   scheme=scheme, tile=TILE, layers=layers, kernels=kernels)
        ref.append(np.asarray(j))
        got.append(t.numpy())
    return got, ref, tb


# every scheme on textured cornell; the layer scenes on two schemes each
# (flexlight_tpu compiles a frame per scheme, layer count and buffer shape)
CASES = [("cornell", 1, "scan"), ("cornell", 1, "packet"), ("cornell", 1, "kernel"),
         ("cornell", 1, "sparse"), ("wall_first", 4, "scan"), ("wall_first", 4, "kernel"),
         ("glass_first", 4, "scan"), ("glass_first", 4, "kernel"), ("opaque", 4, "packet")]


@pytest.mark.parametrize("name,layers,scheme", CASES)
def test_raster_frame_matches_flexlight_tpu(recorded_casts, name, layers, scheme):
    (got,), (ref,), tb = _frames(name, scheme, None, layers)
    tie = _tie_pixels(tb, recorded_casts)
    d = np.abs(got - ref).max(axis=-1)
    assert got.shape == (SIZE, SIZE, 3) and np.isfinite(got).all()
    assert float(d[~tie].max(initial=0.0)) <= 1e-5, (d[~tie].max(), (d > 1e-5).sum())
    assert tie.mean() <= 0.1, tie.mean()
    assert got.mean() > 0.05


def _dilate(mask, r: int):
    t = torch.from_numpy(mask.astype(np.float32))[None, None]
    return (torch.nn.functional.max_pool2d(t, 2 * r + 1, 1, r)[0, 0] > 0).numpy()


@pytest.mark.parametrize("aa,n_frames,reach", [("fxaa", 1, 8), ("taa", 3, 1)])
def test_raster_frame_with_aa_matches_flexlight_tpu(monkeypatch, recorded_casts, aa,
                                                    n_frames, reach):
    """Textured cornell on scan with FXAA (1 frame) and TAA (3 jittered
    frames). Each side's AA input is recorded (flexlight_tpu's through a
    host callback in a frame compiled for this test). The inputs must be
    identical on every pixel none of whose casts is a knife edge (FXAA
    given the same input: tests/test_torch_post.py); and the frames to 1e-5 on
    every pixel whose AA inputs, in every frame so far, are identical
    within `reach` (FXAA: its 3 x 3 test and 6 search steps; TAA: its
    3 x 3 clamp)."""
    inputs = {"port": [], "jax": []}
    real_port = R.KERNELS.fxaa if aa == "fxaa" else chain.taa_apply
    real_jax = JR.fxaa_auto if aa == "fxaa" else JR.taa_apply

    def port_rec(*args):
        inputs["port"].append(args[-1].numpy())
        return real_port(*args)

    def jax_rec(*args):
        jax.debug.callback(lambda x: inputs["jax"].append(np.asarray(x)), args[-1])
        return real_jax(*args)

    kernels = R.KERNELS
    if aa == "fxaa":
        kernels = R.KERNELS._replace(fxaa=port_rec)
        monkeypatch.setattr(JR, "fxaa_auto", jax_rec)
    else:
        monkeypatch.setattr(chain, "taa_apply", port_rec)
        monkeypatch.setattr(JR, "taa_apply", jax_rec)
    monkeypatch.setattr(JR, "raster_frame", jax.jit(
        JR.raster_frame.__wrapped__,
        static_argnames=("width", "height", "config", "scheme", "tile", "layers")))
    got, ref, tb = _frames("cornell", "scan", aa, 1, n_frames, kernels=kernels)
    tie = _tie_pixels(tb, recorded_casts)
    assert len(inputs["port"]) == len(inputs["jax"]) == n_frames
    differ = np.zeros((SIZE, SIZE), dtype=bool)
    for a, b in zip(inputs["port"], inputs["jax"]):
        diff = np.abs(a - b).max(axis=-1) > 0
        assert not (diff & ~tie).any(), np.nonzero(diff & ~tie)
        differ |= diff
    clean = ~_dilate(differ, reach)
    for g, r in zip(got, ref):
        assert np.isfinite(g).all()
        assert float(np.abs(g - r).max(axis=-1)[clean].max(initial=0.0)) <= 1e-5
    assert clean.mean() >= 0.1, clean.mean()


def test_rasterizer_frame_against_the_golden(recorded_casts):
    """The engine's rasterizer (the port's classes) on cornell with
    max_reflections 1 and scheme "scan", as tests/test_goldens.py renders
    the golden: the golden's 2e-3 on every pixel none of whose casts is a
    knife edge (those, ~1% of cornell's pixels, may take the other
    triangle of a wall's diagonal or another shadow verdict)."""
    from tests.scenes import cornell_config
    from tests.test_torch_scene_copy import build

    golden = np.load(GOLDEN)["img"]
    e = port.FlexLight((SIZE, SIZE), device="cpu")
    e.scene, e.camera = build("cornell", port)
    e.config = port.Config(**vars(cornell_config(max_reflections=1)))
    e.renderer.scheme = "scan"
    img = e.renderer.render_frame()
    tie = _tie_pixels(e.renderer._buffers, recorded_casts)
    d = np.abs(img - golden).max(axis=-1)
    assert img.shape == golden.shape and np.isfinite(img).all()
    assert float(d[~tie].max(initial=0.0)) <= 2e-3, (d[~tie].max(), (d > 2e-3).sum())
    assert tie.mean() <= 0.1 and d.max() <= 0.5


def test_simple_frame_matches_flexlight_tpu(monkeypatch):
    """simple_frame on cornell: both casts are scan casts; 1e-5 away from
    knife edges (both casts' rays taken from the port's frame)."""
    jb, tb, camera = _buffers("cornell")
    view = camera.view_matrix(SIZE, SIZE)
    ref = np.asarray(jsimple(jb, jnp.asarray(camera.position), jnp.asarray(view),
                             width=SIZE, height=SIZE))
    from flexlight_tpu_torch.ops import traverse as ttrv

    casts = []
    real = ttrv.traverse_scan, ttrv.shadow_scan

    def closest(g, o, d, **kw):
        casts.append((False, o, d, torch.full_like(o[:, 0], POW32)))
        return real[0](g, o, d, **kw)

    def shadow(g, o, d, max_len, **kw):
        casts.append((True, o, d, max_len))
        return real[1](g, o, d, max_len, **kw)

    monkeypatch.setattr(ttrv, "traverse_scan", closest)
    monkeypatch.setattr(ttrv, "shadow_scan", shadow)
    got = simple_frame(tb, camera.position, view, SIZE, SIZE).numpy()
    tie = _tie_pixels(tb, casts)
    d = np.abs(got - ref).max(axis=-1)
    assert float(d[~tie].max(initial=0.0)) <= 1e-5
    assert tie.mean() <= 0.1 and got.mean() > 0.05


def test_engine_routes_and_auto_scheme():
    """The default renderer is the rasterizer; api "simple" and "webgpu"
    give the simple renderer for either name; the rasterizer's "auto" is
    "kernel" below 4096 triangles and "sparse" from there, on the CPU too."""
    from tests.test_torch_scene_copy import build

    e = port.FlexLight((8, 8), device="cpu")
    e.scene, e.camera = build("cornell", port)
    e.config = port.Config(temporal=False, filter=False, antialiasing=None)
    r = e.renderer
    assert isinstance(r, R.Rasterizer) and r.device == torch.device("cpu")
    assert r.resolved_scheme() == "kernel" and r.resolved_layers() == 1
    img = r.render_frame()
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert r.metrics.last["scheme"] == "kernel" and r.metrics.last["layers"] == 1
    r._buffers = r._buffers._replace(id_buffer=torch.zeros(4096, dtype=torch.int32))
    assert r.resolved_scheme() == "sparse"
    for api in ("simple", "webgpu"):
        e.api = api
        for name in ("rasterizer", "pathtracer"):
            e.renderer = name
            assert isinstance(e.renderer, SimplePathTracer)
        assert e.renderer.render_frame().shape == (8, 8, 3)
    e.api = "tpu"
    e.renderer = "pathtracer"
    assert type(e.renderer).__name__ == "PathTracer"


@pytest.mark.parametrize("scheme", ["mxu", "clustered"])
def test_unported_schemes_raise(recorded_casts, scheme):
    """The mxu and clustered schemes are ported now (the name stays from
    when they raised): raster_frame on each, on the translucent layer
    scene at layers = 4, against flexlight_tpu's on the same scheme, with
    the tolerances of test_raster_frame_matches_flexlight_tpu; and the
    Rasterizer renders on them through render_frame."""
    (got,), (ref,), tb = _frames("wall_first", scheme, None, 4)
    tie = _tie_pixels(tb, recorded_casts)
    d = np.abs(got - ref).max(axis=-1)
    assert got.shape == (SIZE, SIZE, 3) and np.isfinite(got).all()
    assert float(d[~tie].max(initial=0.0)) <= 1e-5, (d[~tie].max(), (d > 1e-5).sum())
    assert tie.mean() <= 0.1 and got.mean() > 0.05
    _, tb, camera = _buffers("wall_first")
    r = R.Rasterizer(8, 8, None, camera, port.Config(), "cpu", scheme=scheme)
    r._buffers = tb
    assert r.render_frame().shape == (8, 8, 3) and r.metrics.last["scheme"] == scheme
