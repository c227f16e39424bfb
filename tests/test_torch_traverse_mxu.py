"""The port's mxu casts (ops/traverse_mxu.py, plain float32 PyTorch)
against flexlight_tpu's (ops/traverse_mxu.py) on the same inputs, the
four tests of tests/test_traverse_mxu.py, and scheme="mxu" on both
renderers.

flexlight_tpu takes the [N, 16] @ [16, 4T] product with jnp.dot, the port
in k order (16 rank-1 updates), so a ray may be decided apart where it
is a knife edge (tests/test_torch_traverse.py `knife_edge_rays`); on every
other ray the triangle ids are identical and s / u / v agree to 1e-5.
The port's k-order products are those of the closest-hit and any-hit
kernels' plain versions (scheme="kernel"), so on rays with a nonzero
direction the mxu casts give their results exactly, and a mxu frame is
the kernel frame value for value."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from flexlight_tpu.ops import buffers as jbuf  # noqa: E402
from flexlight_tpu.ops import traverse_mxu as JM  # noqa: E402
from flexlight_tpu.ops.geometry import world_geometry as jworld  # noqa: E402
import flexlight_tpu_torch as port  # noqa: E402
from flexlight_tpu_torch.models.pathtracer import PathTracer  # noqa: E402
from flexlight_tpu_torch.models.rasterizer import Rasterizer  # noqa: E402
from flexlight_tpu_torch.ops import intersect as I  # noqa: E402
from flexlight_tpu_torch.ops import intersect_kernel as IK  # noqa: E402
from flexlight_tpu_torch.ops import traverse_mxu as TM  # noqa: E402
from flexlight_tpu_torch.ops.buffers import buffers_from_numpy  # noqa: E402
from flexlight_tpu_torch.ops.geometry import world_geometry as tworld  # noqa: E402
from flexlight_tpu_torch.ops.intersect import BIAS, POW32  # noqa: E402
from tests.scenes import cornell_scene  # noqa: E402
from tests.test_torch_traverse import knife_edge_rays  # noqa: E402

N = 512


@pytest.fixture(scope="module")
def cornell():
    """Cornell's buffers on both sides, its W on both, and the camera."""
    scene, camera = cornell_scene()
    jb = jbuf.build_scene_buffers(scene)
    tb = buffers_from_numpy(jax.tree.map(np.asarray, jb), "cpu")
    jw = JM.build_tri_matrix(jworld(jb), jb.id_buffer)
    tw = TM.build_tri_matrix(tworld(tb), tb.id_buffer)
    w4 = IK.build_w4(tworld(tb), tb.id_buffer)[0]
    return dict(jb=jb, tb=tb, jw=jw, tw=tw, w4=w4, camera=camera)


def _rays(camera, n, seed=0):
    """tests/test_traverse_mxu.py's rays: from around the camera, into the
    box."""
    rng = np.random.default_rng(seed)
    origin = np.tile(camera.position, (n, 1)).astype(np.float32)
    origin += rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.1
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return origin, d


def _soa(x):
    return tuple(torch.from_numpy(np.ascontiguousarray(x[:, c])) for c in range(3))


@pytest.mark.parametrize("edge", [BIAS, -BIAS])
def test_traverse_mxu_matches(cornell, edge):
    o, d = _rays(cornell["camera"], N)
    ref = JM.traverse_mxu(cornell["jw"], cornell["jb"].id_buffer, jnp.asarray(o),
                          jnp.asarray(d), edge=edge)
    got = TM.traverse_mxu(cornell["tw"], cornell["tb"].id_buffer, torch.from_numpy(o),
                          torch.from_numpy(d), edge=edge)
    tie = knife_edge_rays(cornell["w4"], _soa(o), _soa(d), torch.full((N,), POW32), edge,
                          False).numpy()
    jt, tt = np.asarray(ref.triangle), got.triangle.numpy()
    assert (jt[~tie] == tt[~tie]).all(), np.nonzero((jt != tt) & ~tie)
    assert tie.mean() <= 0.1 and (tt >= 0).mean() > 0.9
    same = jt == tt
    np.testing.assert_allclose(got.suv.numpy()[same], np.asarray(ref.suv)[same], rtol=1e-5,
                               atol=1e-5)
    # the kernel scheme's plain closest hit on the same rays: identical
    s, u, v, tri = IK.closest_hit_plain(cornell["w4"], cornell["tb"].id_buffer, _soa(o),
                                        _soa(d), torch.full((N,), POW32), edge)
    assert torch.equal(tri, got.triangle)
    assert torch.equal(torch.stack([s, u, v], dim=-1), got.suv)


def test_shadow_mxu_matches(cornell):
    # the culled any hit sees the box's walls from outside only: seeded
    # rays from inside the box in every direction, of seeded lengths (the
    # camera's rays of tests/test_traverse_mxu.py hit no front face)
    rng = np.random.default_rng(5)
    o = rng.uniform(-4.9, 4.9, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    max_len = rng.uniform(0.0, 12.0, N).astype(np.float32)
    ref = JM.shadow_mxu(cornell["jw"], jnp.asarray(o), jnp.asarray(d), jnp.asarray(max_len))
    got = TM.shadow_mxu(cornell["tw"], *(torch.from_numpy(x) for x in (o, d, max_len)))
    tie = knife_edge_rays(cornell["w4"], _soa(o), _soa(d), torch.from_numpy(max_len), BIAS,
                          True).numpy()
    ref, got_np = np.asarray(ref), got.numpy()
    assert (ref[~tie] == got_np[~tie]).all()
    assert tie.mean() <= 0.05 and 0.05 < got_np.mean() < 0.95
    assert torch.equal(got, IK.any_hit_plain(cornell["w4"], _soa(o), _soa(d),
                                             torch.from_numpy(max_len)))


def test_traverse_mxu_blocked_path(cornell):
    """The block only bounds memory: 128-ray blocks (and a budget that
    makes 3-ray blocks) give the unblocked result exactly."""
    o, d = (torch.from_numpy(x) for x in _rays(cornell["camera"], 300, seed=2))
    full = TM.traverse_mxu(cornell["tw"], cornell["tb"].id_buffer, o, d, block=300)
    for block in (128, 3):
        part = TM.traverse_mxu(cornell["tw"], cornell["tb"].id_buffer, o, d, block=block)
        assert torch.equal(full.triangle, part.triangle) and torch.equal(full.suv, part.suv)
    ml = torch.full((300,), 6.0)
    assert torch.equal(TM.shadow_mxu(cornell["tw"], o, d, ml, block=7),
                       TM.shadow_mxu(cornell["tw"], o, d, ml))
    assert TM._blocks(2_073_600, 8192, None)[0] == (0, TM.MXU_BLOCK_VALUES // (4 * 8192))


def test_mt_rows_moved_without_a_change(cornell):
    """tri_rows / mt_products live in ops.intersect; ops.traverse_mxu and
    ops.intersect_kernel use the same objects, and W is the reference's
    layout."""
    assert IK.tri_rows is TM.tri_rows is I.tri_rows
    assert IK.mt_products is TM.mt_products is I.mt_products
    w4 = TM._planes(cornell["tw"])
    assert torch.equal(w4, cornell["w4"])
    np.testing.assert_allclose(cornell["tw"].numpy(), np.asarray(cornell["jw"]), rtol=1e-6,
                               atol=1e-5)


def test_render_mxu_matches_flexlight_tpu(cornell, monkeypatch):
    """render_mrt(scheme="mxu") of both packages, cornell at 16 x 16,
    counter RNG, 2 bounces: 1e-5 on every pixel none of whose casts is a
    knife edge; and the port's mxu MRT equals its kernel-scheme MRT."""
    from flexlight_tpu import Config
    from flexlight_tpu.ops.pathtrace import render_mrt as jrender
    from flexlight_tpu_torch.ops import pathtrace as tpt

    size, camera = 16, cornell["camera"]
    cfg = Config(temporal=False, filter=False, antialiasing=None, max_reflections=2,
                 rng="counter")
    view = camera.view_matrix(size, size)
    ref = jrender(cornell["jb"], size, size, jnp.asarray(camera.position), jnp.asarray(view),
                  cfg, jnp.float32(0.0), scheme="mxu")
    casts = []
    real = tpt.scheme_casts

    def recording(*args):
        traverse, shadow = real(*args)

        def closest(o3, d3, alive=None, edge=BIAS, bounce=False):
            casts.append((False, o3, d3, torch.full_like(o3[0], POW32), edge))
            return traverse(o3, d3, alive=alive, edge=edge, bounce=bounce)

        def any_hit(o3, d3, max_len, alive=None, bounce=False):
            casts.append((True, o3, d3, max_len, BIAS))
            return shadow(o3, d3, max_len, alive=alive, bounce=bounce)

        return closest, any_hit

    monkeypatch.setattr(tpt, "scheme_casts", recording)
    tcfg = port.Config(**vars(cfg))
    got = tpt.render_mrt(cornell["tb"], size, size, camera.position, view, tcfg, 0.0,
                         scheme="mxu")
    tie = torch.zeros(size * size, dtype=torch.bool)
    for any_hit, o3, d3, max_len, edge in casts:
        tie |= knife_edge_rays(cornell["w4"], tuple(c.contiguous() for c in o3),
                               tuple(c.contiguous() for c in d3), max_len.contiguous(), edge,
                               any_hit)
    assert len(casts) == 4 and tie.float().mean() <= 0.15
    for field in ref._fields:
        a = np.asarray(getattr(ref, field)).reshape(size * size, -1)
        b = getattr(got, field).numpy().reshape(size * size, -1)
        assert float(np.abs(a - b).max(axis=-1)[~tie.numpy()].max()) <= 1e-5, field
    monkeypatch.setattr(tpt, "scheme_casts", real)
    kernel = tpt.render_mrt(cornell["tb"], size, size, camera.position, view, tcfg, 0.0,
                            scheme="kernel")
    assert all(torch.equal(a, b) for a, b in zip(got, kernel))


@pytest.mark.parametrize("renderer", [PathTracer, Rasterizer])
def test_mxu_frames_are_the_kernel_frames(renderer):
    """Both renderers on scheme="mxu", through render_frame (theater, the
    full pipeline of each): the same frames as on scheme="kernel"."""
    from flexlight_tpu_torch import reset_global_registry
    from flexlight_tpu_torch.scenes import stand_in_wood_texture, theater

    reset_global_registry()
    e = theater(stand_in_wood_texture(0), device="cpu")
    cfg = port.Config(temporal=True, temporal_samples=2, filter=True, antialiasing="fxaa",
                      max_reflections=2)
    frames = {}
    for scheme in ("mxu", "kernel"):
        r = renderer(16, 12, e.scene, e.camera, cfg, "cpu", scheme=scheme)
        frames[scheme] = [r.render_frame() for _ in range(2)]
        assert r.metrics.last["scheme"] == scheme
    for a, b in zip(frames["mxu"], frames["kernel"]):
        np.testing.assert_array_equal(a, b)
    assert frames["mxu"][-1].max() > 0.0
