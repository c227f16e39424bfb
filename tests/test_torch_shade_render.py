"""render_mrt(shade_kernel=True) of the port at the frame level: against
flexlight_tpu's render_mrt with its shade kernels on
(FLEXLIGHT_SHADE_KERNEL="xla", FLEXLIGHT_FORCE_2D=1: the kernel bodies
traced as plain XLA ops, which needs the whole frame in one ray tile of
<= 1024 rays), against the port's own frame with the switch off, the
routing, and the entry points.

The three frames, counter RNG, each scene built by each package:
- cornell at 24x24 on scheme="kernel": 1x1 atlases, so interp_shade
  (kernel 12);
- cornell with a 128x128 RME texture (tests/test_fused.py:_setup_big_atlas)
  at 24x24 on scheme="kernel": shade (kernel 11);
- a seeded 2,066-triangle OBJ at 32x32 on scheme="sparse" (block-tiled
  rays, sorted bounce casts): interp_shade.
Cornell is rendered at 24 px as in tests/test_torch_render.py: at 32 px
three of its pixels lie on a primary-hit edge tie, where flexlight_tpu's
kernel scheme and the port decide apart with the switch off as well.
Tolerances: every MRT channel to 1e-5 on cornell (as
tests/test_torch_render.py); on the OBJ the RNG-free channels (alpha,
location_id, original_color, glass) and color to 1e-5 on all pixels but at
most 0.5%, and those only pixels one of whose casts has a ray in the tie
set of tests/test_torch_sparse.py (as tests/test_torch_sparse_render.py).
With the plain versions the port's frame with the switch on equals its
frame with the switch off bit for bit: the kernels' plain versions are the
same stage functions."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import flexlight_tpu as jpkg  # noqa: E402
from flexlight_tpu.ops import buffers as jbuf  # noqa: E402
from flexlight_tpu.ops.pathtrace import render_mrt as jrender  # noqa: E402
import flexlight_tpu_torch as port  # noqa: E402
from flexlight_tpu_torch.kernels import KERNELS, PLAIN  # noqa: E402
from flexlight_tpu_torch.models.pathtracer import PathTracer  # noqa: E402
from flexlight_tpu_torch.ops import intersect_kernel as IK  # noqa: E402
from flexlight_tpu_torch.ops import shade as S  # noqa: E402
from flexlight_tpu_torch.ops import buffers as tbuf  # noqa: E402
from flexlight_tpu_torch.ops.buffers import buffers_from_numpy  # noqa: E402
from flexlight_tpu_torch.ops.fused import N_CARRY  # noqa: E402
from flexlight_tpu_torch.ops.geometry import world_geometry  # noqa: E402
from flexlight_tpu_torch.ops.pathtrace import block_untile, render_mrt  # noqa: E402
from flexlight_tpu_torch.scene import transform as ttransform  # noqa: E402
from flexlight_tpu_torch.scenes import dragon, stand_in_wood_texture, theater  # noqa: E402
from tests.test_fused import _setup_big_atlas  # noqa: E402
from tests.test_torch_scene_copy import assert_same_buffers, both_buffers  # noqa: E402
from tests.test_torch_sparse import tie_rays  # noqa: E402
from tests.test_torch_sparse_render import _mesh_scene, _recording, mesh_obj  # noqa: E402,F401

SIZES = {"cornell": 24, "big_atlas": 24, "mesh": 32}
RNG_FREE = ("alpha", "location_id", "original_color", "glass")


def _config(max_reflections, spp=1):
    return port.Config(temporal=False, filter=False, antialiasing=None, rng="counter",
                       max_reflections=max_reflections, samples_per_ray=spp)


def _buffers(name, mesh_obj):
    """(flexlight_tpu buffers, port buffers, camera position, view matrix,
    scheme, size) of one of the three frames."""
    size = SIZES[name]
    if name == "cornell":
        jb, tb, camera = both_buffers("cornell")
        assert_same_buffers(jb, tb)
        return jb, tb, camera.position, camera.view_matrix(size, size), "kernel", size
    if name == "big_atlas":
        jb, pos, view = _setup_big_atlas(size=size)
        tb = buffers_from_numpy(jax.tree.map(np.asarray, jb), "cpu")
        return jb, tb, np.array(pos), np.array(view), "kernel", size
    jscene, _ = _mesh_scene(jpkg, mesh_obj)
    tscene, camera = _mesh_scene(port, mesh_obj)
    jb = jbuf.build_scene_buffers(jscene)
    tb = tbuf.build_scene_buffers(tscene, "cpu")
    assert_same_buffers(jb, tb)
    return jb, tb, camera.position, camera.view_matrix(size, size), "sparse", size


FRAMES = [("cornell", True, 3), ("big_atlas", False, 3), ("mesh", True, 2)]


@pytest.mark.parametrize("spp", [1, 2])
@pytest.mark.parametrize("name,step,bounces", FRAMES)
def test_shade_kernel_frame_equals_the_eager_frame(mesh_obj, monkeypatch, name, step, bounces,
                                                   spp):
    """The plain kernels route as flexlight_tpu does and give the eager
    frame bit for bit, also when a second sample starts from the carried
    channels that the state block holds. The carry lives in the state
    block: after each sample's first bounce, the drop-ins copy into it no
    carry row but bounce_pre's alive and ray origin on the shade route
    (every other row is written in place)."""
    _, tb, pos, view, scheme, size = _buffers(name, mesh_obj)
    assert S.fused_step_eligible(tb) == step and S.shade_kernel_eligible(tb)
    calls = {"shade": 0, "interp_shade": 0}

    def count(kind):
        def fn(*a):
            calls[kind] += 1
            return getattr(S, f"{kind}_plain")(*a)
        return fn

    copied = []   # per packing of the carry: the state rows it copies
    pack = S._pack_rows

    def recording_pack(state, rows, first=0):
        if first == 0:
            copied.append([k for k, x in enumerate(rows)
                           if x.data_ptr() != state[k].data_ptr() or x.dtype != state.dtype])
        pack(state, rows, first)

    monkeypatch.setattr(S, "_pack_rows", recording_pack)
    kernels = PLAIN._replace(shade=count("shade"), interp_shade=count("interp_shade"))
    cfg = _config(bounces, spp)
    got = render_mrt(tb, size, size, pos, view, cfg, 1.0, scheme=scheme, kernels=kernels,
                     shade_kernel=True)
    ref = render_mrt(tb, size, size, pos, view, cfg, 1.0, scheme=scheme, kernels=PLAIN,
                     shade_kernel=False)
    n = bounces * spp
    assert calls == {"shade": 0 if step else n, "interp_shade": n if step else 0}
    pre_rows = [] if step else [S.ALIVE, S.RAY_ORIGIN, S.RAY_ORIGIN + 1, S.RAY_ORIGIN + 2]
    assert len(copied) == n and len(copied[0]) == N_CARRY
    for j, rows in enumerate(copied):
        if j % bounces:
            assert rows == pre_rows, (j, rows)
        elif j:
            # a later sample's first bounce: bounce_carry_init's rows, but
            # the shader globals that the state carries across samples
            assert not set(rows) & {*range(S.RENDER_ID, S.RENDER_ID + 4), S.GLASS, S.RME_X,
                                    S.TPO_X, S.FIRST_RAY_LENGTH}, (j, rows)
    for ch in ref._fields:
        assert torch.equal(getattr(got, ch), getattr(ref, ch)), ch
    assert got.alpha.mean() > 0.3 and got.color.max() > 0


@pytest.mark.parametrize("name,step,bounces", FRAMES)
def test_shade_kernel_frame_matches_flexlight_tpu(mesh_obj, monkeypatch, name, step, bounces):
    jb, tb, pos, view, scheme, size = _buffers(name, mesh_obj)
    cfg = _config(bounces)
    monkeypatch.setenv("FLEXLIGHT_SHADE_KERNEL", "xla")
    monkeypatch.setenv("FLEXLIGHT_FORCE_2D", "1")
    ref = jrender(jb, size, size, jnp.asarray(pos), jnp.asarray(view), jpkg.Config(**vars(cfg)),
                  jnp.float32(0.0), scheme=scheme)
    casts = _recording(monkeypatch) if scheme == "sparse" else None
    got = render_mrt(tb, size, size, pos, view, cfg, 0.0, scheme=scheme, kernels=PLAIN,
                     shade_kernel=True)
    assert got.alpha.numpy().mean() > 0.3
    if scheme == "kernel":
        for ch in ref._fields:
            np.testing.assert_allclose(getattr(got, ch).numpy(), np.asarray(getattr(ref, ch)),
                                       atol=1e-5, rtol=0, err_msg=ch)
        return
    w4 = IK.build_w4(world_geometry(tb), tb.id_buffer)[0]
    tie = torch.zeros(size * size, dtype=torch.bool)
    for o3, d3, ml, edge, any_hit in casts:
        tie |= tie_rays(w4, o3, d3, ml, edge, any_hit)
    tie = block_untile(tie, size, size, 32, 32).numpy()
    for ch in RNG_FREE + ("color",):
        d = np.abs(getattr(got, ch).numpy() - np.asarray(getattr(ref, ch)))
        bad = (d > 1e-5).reshape(size * size, -1).any(axis=-1)
        assert bad.mean() <= 0.005 and not (bad & ~tie).any(), (ch, np.flatnonzero(bad & ~tie))


def test_routing_and_what_raises(tmp_path):
    """The dragon stand-in (no textures) takes interp_shade, theater
    (textured floor) shade, by default on a CUDA device (bounce_shading
    told the device type, so no card is needed) and eagerly on the CPU;
    scheme="fused_split" with the switch on raises and renders under the
    default; a scene with more lights than the kernels take raises with
    the switch on and takes the eager loop under the default."""
    ttransform.reset_global_registry()
    engine, _ = dragon(0, tmp_path / "objects", device="cpu")
    db = engine.renderer._buffers
    assert S.fused_step_eligible(db)
    e = theater(stand_in_wood_texture(0), device="cpu")
    tracer = PathTracer(8, 8, e.scene, e.camera, _config(2), "cpu", shade_kernel=True)
    assert tracer.resolved_scheme() == "fused_split"
    tb = tracer._buffers
    assert S.shade_kernel_eligible(tb) and not S.fused_step_eligible(tb)
    many = tb._replace(lights=tb.lights[[0]].repeat(S.MAX_LIGHTS + 1, 1, 1))
    for buffers, scheme, cuda in ((db, "sparse", "interp_shade"), (db, "kernel", "interp_shade"),
                                  (tb, "kernel", "shade"), (tb, "sparse", "shade"),
                                  (many, "kernel", "eager"), (tb, "scan", "eager"),
                                  (tb, "clustered", "eager")):
        assert S.bounce_shading(buffers, scheme, None, "cuda") == cuda, (scheme, cuda)
        assert S.bounce_shading(buffers, scheme, None, "cpu") == "eager"
        assert S.bounce_shading(buffers, scheme, False, "cuda") == "eager"
    assert S.bounce_shading(db, "sparse", True, "cpu") == "interp_shade"
    assert S.bounce_shading(tb, "kernel", True, "cpu") == "shade"
    with pytest.raises(ValueError, match="scan"):
        S.bounce_shading(tb, "scan", True, "cuda")
    with pytest.raises(ValueError, match="fused_split"):
        tracer.render_frame()
    tracer.shade_kernel = None
    assert tracer.render_frame().shape == (8, 8, 3)
    pos, view = e.camera.position, e.camera.view_matrix(8, 8)
    with pytest.raises(ValueError, match="lights"):
        render_mrt(many, 8, 8, pos, view, _config(2), 0.0, scheme="kernel", kernels=PLAIN,
                   shade_kernel=True)
    # without the switch such a scene renders eagerly
    render_mrt(many, 8, 8, pos, view, _config(1), 0.0, scheme="kernel", kernels=PLAIN)


def test_the_switch_through_the_entry_points(monkeypatch):
    """FlexLight(canvas, device) -> renderer "pathtracer" -> shade_kernel =
    True / None / False -> render_frame(): theater on scheme="kernel"
    reaches the shade wrapper once per bounce with the switch on, not
    under the default on the CPU (the eager loop) nor with it off, and
    the three give the same frames."""
    calls = []
    plain = KERNELS.shade.plain
    monkeypatch.setattr(KERNELS.shade, "plain", lambda *a: calls.append(a[-2]) or plain(*a))
    cfg = port.Config(temporal=True, temporal_samples=2, filter=True, antialiasing="fxaa",
                      max_reflections=3)
    frames = []
    for switch in (True, None, False):
        e = theater(stand_in_wood_texture(0), device="cpu")
        e.canvas = (16, 12)
        e.config = cfg
        e.renderer = "pathtracer"
        e.renderer.scheme = "kernel"
        assert e.renderer.shade_kernel is None
        e.renderer.shade_kernel = switch
        frames.append([e.renderer.render_frame() for _ in range(2)])
    assert calls == [0, 1, 2] * 2
    for a, b, c in zip(*frames):
        assert a.shape == (12, 16, 3) and np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
