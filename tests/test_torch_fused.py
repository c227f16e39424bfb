"""scheme="fused_split" of the port (ops.fused with the plain versions of
the PRE / POST kernels, as the CPU runs it) against flexlight_tpu's
render_mrt_fused_split(pallas=False), at 16 px with <= 3 bounces; the
auto dispatch; and the dead-ray rule of POST.

Each side renders the scene built with its own package's classes; both
flatten to identical buffers first. The reference is flexlight_tpu run op
by op (pallas=False traces the same kernel bodies as plain XLA ops).

Tolerances, with their reasons (as in tests/test_torch_render.py):
- RNG-free channels (alpha, location_id, original_color, glass): 1e-5.
- color under rng="counter" (integer hash, bit-exact): 1e-5 on cornell.
- color under rng="hash": the sin amplifies a 1-ulp libm difference, so
  the hash tests put flexlight_tpu's own sin in the port (`reference_sin`)
  and hold the same 1e-5 on cornell.
- theater, example2 and the second sample: a traversal tie or a
  reservoir choice on a knife edge moves a few pixels. flexlight_tpu's
  fused_split sums its triangle products in XLA's dot order, which decides
  fp ties otherwise than its own mxu scheme (on cornell at 16 px with
  spp 2 the two differ by 0.024 on one pixel, where the port agrees with
  mxu to 2e-7). The budget is the JAX package's own between its schemes
  (tests/test_examples.py:82-88): <= 5% of pixels over 1e-3.
- the port's fused_split against its own scheme="kernel": identical. The
  stages and the traversal arithmetic are the same functions.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import flexlight_tpu as jpkg  # noqa: E402
from flexlight_tpu.ops.fused import render_mrt_fused_split as jax_fused_split  # noqa: E402
import flexlight_tpu_torch as port  # noqa: E402
from flexlight_tpu_torch.kernels import PLAIN  # noqa: E402
from flexlight_tpu_torch.models.pathtracer import PathTracer  # noqa: E402
from flexlight_tpu_torch.ops import fused as F  # noqa: E402
from flexlight_tpu_torch.ops import rng as trng  # noqa: E402
from flexlight_tpu_torch.ops.buffers import build_scene_buffers  # noqa: E402
from flexlight_tpu_torch.ops.pathtrace import render_mrt  # noqa: E402
from tests.test_torch_scene_copy import assert_same_buffers, both_buffers, build  # noqa: E402

SIZE = 16
RNG_FREE = ("alpha", "location_id", "original_color", "glass")


@pytest.fixture
def reference_sin(monkeypatch):
    """flexlight_tpu's sin in the port's hash."""
    monkeypatch.setattr(trng, "_sin", lambda x: torch.from_numpy(np.array(
        jnp.sin(jnp.asarray(x.numpy())))))


def _config(rng, max_reflections, spp=1):
    return port.Config(temporal=False, filter=False, antialiasing=None, rng=rng,
                       max_reflections=max_reflections, samples_per_ray=spp)


def _mrts(name, rng, max_reflections, spp=1):
    jb, tb, camera = both_buffers(name)
    assert_same_buffers(jb, tb)
    cfg = _config(rng, max_reflections, spp)
    pos, view = camera.position, camera.view_matrix(SIZE, SIZE)
    jcfg = jpkg.Config(**vars(cfg))
    ref = jax_fused_split(jb, SIZE, SIZE, jnp.asarray(pos), jnp.asarray(view), jcfg,
                          jnp.float32(0.0), pallas=False)
    got = render_mrt(tb, SIZE, SIZE, pos, view, cfg, 0.0, scheme="fused_split",
                     kernels=PLAIN)
    return ref, got, tb, camera, cfg


def _assert_channels(ref, got, names, atol):
    for ch in names:
        np.testing.assert_allclose(getattr(got, ch).numpy(), np.asarray(getattr(ref, ch)),
                                   atol=atol, rtol=0, err_msg=ch)


def _color_budget(ref, got):
    d = np.abs(got.color.numpy() - np.asarray(ref.color)).max(axis=-1)
    assert (d > 1e-3).mean() <= 0.05, (d > 1e-3).mean()


def test_fused_split_cornell_counter_is_exact():
    ref, got, *_ = _mrts("cornell", "counter", 3)
    _assert_channels(ref, got, ref._fields, 1e-5)
    assert got.alpha.numpy().mean() > 0.5 and got.color.numpy().max() > 0


def test_fused_split_cornell_hash_is_exact_with_reference_sin(reference_sin):
    ref, got, *_ = _mrts("cornell", "hash", 3)
    _assert_channels(ref, got, ref._fields, 1e-5)


@pytest.mark.parametrize("name,rng", [("theater", "counter"), ("theater", "hash"),
                                      ("example2", "counter")])
def test_fused_split_textured_and_many_lights(reference_sin, name, rng):
    """theater (textured floor, 9 lights) and example2 (64 light slots, 63
    set: more than the 16 below which flexlight_tpu unrolls its reservoir
    loop)."""
    ref, got, tb, *_ = _mrts(name, rng, 2)
    assert tb.lights.shape[0] == (63 if name == "example2" else 9)
    _assert_channels(ref, got, RNG_FREE, 1e-5)
    _color_budget(ref, got)


def test_fused_split_second_sample_resamples():
    """spp = 2: PRE reads the first sample's primary hit and carried
    channels from the state instead of casting again."""
    ref, got, *_ = _mrts("cornell", "counter", 2, spp=2)
    _assert_channels(ref, got, RNG_FREE + ("render_id", "original_id_w"), 1e-5)
    _color_budget(ref, got)


@pytest.mark.parametrize("name,spp", [("cornell", 1), ("theater", 1), ("cornell", 2)])
def test_fused_split_equals_the_ports_kernel_scheme(name, spp):
    scene, camera = build(name, port)
    tb = build_scene_buffers(scene, "cpu")
    cfg = _config("counter", 3, spp)
    pos, view = camera.position, camera.view_matrix(SIZE, SIZE)
    a = render_mrt(tb, SIZE, SIZE, pos, view, cfg, 1.0, scheme="fused_split", kernels=PLAIN)
    b = render_mrt(tb, SIZE, SIZE, pos, view, cfg, 1.0, scheme="kernel", kernels=PLAIN)
    for ch in a._fields:
        assert torch.equal(getattr(a, ch), getattr(b, ch)), ch


def _many_triangles_scene():
    """A floor and 86 small cuboids: 2 + 86 * 12 = 1034 triangles, over
    fused_split's 1024."""
    scene = port.Scene()
    scene.primaryLightSources = [[0, 10, 0]]
    floor = scene.Plane([-50, 0, -50], [50, 0, -50], [50, 0, 50], [-50, 0, 50])
    cubes = [scene.Cuboid(x * 2.0, x * 2.0 + 1.0, 0, 1, z * 2.0, z * 2.0 + 1.0)
             for x in range(-5, 5) for z in range(-5, 4)][:86]
    scene.queue.push(floor, cubes)
    camera = port.Camera()
    camera.y, camera.z = 5, -30
    return scene, camera


def test_auto_dispatch_follows_the_chip_rule():
    """"auto" takes fused_split within its caps (theater) and "kernel" above
    1024 triangles, on the CPU as on the card; both render."""
    cfg = _config("counter", 2)
    scene, camera = build("theater", port)
    pt = PathTracer(8, 8, scene, camera, cfg, "cpu")
    assert pt.resolved_scheme() == "fused_split"
    pt.render_frame()
    assert pt.metrics.last["scheme"] == "fused_split"
    scene, camera = _many_triangles_scene()
    pt = PathTracer(8, 8, scene, camera, cfg, "cpu")
    assert pt._buffers is None
    assert pt.resolved_scheme() == "kernel"
    assert pt._buffers.id_buffer.shape[0] == 1034
    img = pt.render_frame()
    assert pt.metrics.last["scheme"] == "kernel" and np.isfinite(img).all()
    assert PathTracer(8, 8, scene, camera, cfg, "cpu", scheme="kernel").resolved_scheme() \
        == "kernel"
    with pytest.raises(ValueError, match="too large"):
        render_mrt(pt._buffers, 8, 8, camera.position, camera.view_matrix(8, 8), cfg, 0.0,
                   scheme="fused_split", kernels=PLAIN)


def _frame_state(name="theater", size=12):
    """The state block and POST inputs of bounce 0 of one frame."""
    from flexlight_tpu_torch.ops.geometry import world_geometry
    from flexlight_tpu_torch.ops.intersect_kernel import build_w4
    from flexlight_tpu_torch.ops.pathtrace import (build_material_table, camera_rays,
                                                   inverse_view)

    scene, camera = build(name, port)
    tb = build_scene_buffers(scene, "cpu")
    cam = torch.as_tensor(camera.position, dtype=torch.float32)
    _, d3, ndc2 = camera_rays(size, size, cam, inverse_view(camera.view_matrix(size, size)))
    wg = world_geometry(tb)
    w4, ids = build_w4(wg, tb.id_buffer)
    mat = build_material_table(tb, wg).contiguous()
    state = torch.empty((F.SP_C, size * size))
    cfg = _config("counter", 3)
    F.sp_pre_plain(state, torch.stack(d3), w4, ids, mat, cam, False, cfg)
    return state, F.tex_block(tb, state), torch.stack(ndc2), w4, ids, mat, tb.lights, cam, cfg


def test_post_leaves_dead_rays_unchanged():
    """Every carry write of bounce_post is guarded by the live mask, so on
    a state whose rays are all dead POST changes nothing but surf.m (0
    already): the kernel's dead rays return at once."""
    state, tex, ndc, w4, ids, mat, lights, cam, cfg = _frame_state()
    state[F.ALIVE] = 0.0
    state[F.SURF] = 0.0
    before = state.clone()
    for i in range(cfg.max_reflections):
        F.sp_post_plain(state, tex, ndc, w4, ids, mat, lights, cam, 2.0, 1.0, i, cfg)
        assert torch.equal(state, before), i


def test_post_changes_live_rays():
    state, tex, ndc, w4, ids, mat, lights, cam, cfg = _frame_state()
    live = state[F.SURF] > 0
    assert live.any() and not live.all()
    before = state.clone()
    F.sp_post_plain(state, tex, ndc, w4, ids, mat, lights, cam, 0.0, 1.0, 0, cfg)
    changed = (state != before).any(dim=0)
    assert torch.equal(changed & ~live, torch.zeros_like(live))
    assert changed[live].all()
    assert torch.equal(state[F.PPART:F.PPART + 4], before[F.PPART:F.PPART + 4])
