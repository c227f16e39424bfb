"""scheme="sparse" of the port against flexlight_tpu's at the frame level,
and the entry points that reach it.

- render_mrt(scheme="sparse") of both packages on the same seeded OBJ,
  imported by each package (2,066 triangles: block-tiled rays and sorted
  bounce casts run), 64x32 px, 2 bounces, counter RNG. The RNG-free
  channels (alpha, location_id, original_color, glass) and color must
  match to 1e-5 on all pixels but at most 0.5%, and those may only be
  pixels one of whose casts has a ray in the tie set of
  tests/test_torch_sparse.py (`tie_rays`).
- The auto rule of flexlight_tpu on a chip at its thresholds.
- The dragon stand-in through FlexLight / render_frame on the CPU."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import flexlight_tpu as jpkg  # noqa: E402
from flexlight_tpu.ops import buffers as jbuf  # noqa: E402
from flexlight_tpu.ops.pathtrace import render_mrt as jrender  # noqa: E402
from flexlight_tpu.scene import transform as jtransform  # noqa: E402
import flexlight_tpu_torch as port  # noqa: E402
from flexlight_tpu_torch.models.pathtracer import PathTracer  # noqa: E402
from flexlight_tpu_torch.ops import buffers as tbuf  # noqa: E402
from flexlight_tpu_torch.ops import intersect_kernel as IK  # noqa: E402
from flexlight_tpu_torch.ops import intersect_sparse as S  # noqa: E402
from flexlight_tpu_torch.ops.geometry import world_geometry  # noqa: E402
from flexlight_tpu_torch.ops.intersect import BIAS, POW32  # noqa: E402
from flexlight_tpu_torch.ops.pathtrace import _pick_block, block_untile, render_mrt  # noqa: E402
from flexlight_tpu_torch.scene import transform as ttransform  # noqa: E402
from flexlight_tpu_torch.scenes import dragon, stand_in_mesh, write_obj  # noqa: E402
from tests.test_torch_scene_copy import assert_same_buffers  # noqa: E402
from tests.test_torch_sparse import tie_rays  # noqa: E402

W, H = 64, 32
RNG_FREE = ("alpha", "location_id", "original_color", "glass")


def _mesh_scene(pkg, path):
    """A glass seeded mesh on a metallic plane under one light (the dragon
    scene's materials), on `pkg`'s classes."""
    (ttransform if pkg is port else jtransform).reset_global_registry()
    scene, camera = pkg.Scene(), pkg.Camera()
    camera.x, camera.y, camera.z = -6, 5, -6
    camera.fx, camera.fy = -0.8, 0.4
    scene.primaryLightSources = [[20, 30, 10]]
    scene.primary_light_sources[0].intensity = 5000
    scene.ambientLight = [0.1, 0.1, 0.1]
    plane = scene.Plane([-50, -1, -50], [50, -1, -50], [50, -1, 50], [-50, -1, 50])
    plane.roughness = 1
    plane.metallicity = 0.8
    scene.queue.push(plane)
    obj = scene.import_obj(path)
    obj.roughness = 0
    obj.metallicity = 1
    obj.translucency = 1
    obj.ior = 1.5
    obj.color = [255, 100, 100]
    scene.queue.push(obj)
    scene.queue[:] = [scene.generate_bvh()]
    return scene, camera


@pytest.fixture(scope="module")
def mesh_obj(tmp_path_factory):
    path = tmp_path_factory.mktemp("obj") / "mesh.obj"
    write_obj(path, *stand_in_mesh(np.random.default_rng(5), 24, 44, (3.0, 2.0, 2.0), 1.0, 0.15))
    return str(path)


def _recording(monkeypatch):
    """Record every sparse cast of the port: (o3, d3, max_len, edge, any_hit)."""
    casts = []
    closest, shadow = S.traverse_sparse_soa, S.shadow_sparse_soa

    def traverse(scene, o3, d3, alive=None, edge=BIAS, **kw):
        ml = torch.full_like(o3[0], POW32)
        casts.append((o3, d3, ml if alive is None else torch.where(alive, ml, 0.0), edge, False))
        return closest(scene, o3, d3, alive=alive, edge=edge, **kw)

    def any_hit(scene, o3, d3, max_len, alive=None, **kw):
        casts.append((o3, d3, max_len if alive is None else torch.where(alive, max_len, 0.0),
                      BIAS, True))
        return shadow(scene, o3, d3, max_len, alive=alive, **kw)

    monkeypatch.setattr(S, "traverse_sparse_soa", traverse)
    monkeypatch.setattr(S, "shadow_sparse_soa", any_hit)
    return casts


def test_render_mrt_sparse_matches_jax(mesh_obj, monkeypatch):
    jscene, _ = _mesh_scene(jpkg, mesh_obj)
    tscene, camera = _mesh_scene(port, mesh_obj)
    jb = jbuf.build_scene_buffers(jscene)
    tb = tbuf.build_scene_buffers(tscene, "cpu")
    assert_same_buffers(jb, tb)
    assert tb.id_buffer.shape[0] >= 2048 and _pick_block(H, W) == (32, 32)
    cfg = jpkg.Config(temporal=False, filter=False, antialiasing=None, max_reflections=2,
                      rng="counter")
    pos, view = camera.position, camera.view_matrix(W, H)
    ref = jrender(jb, W, H, jnp.asarray(pos), jnp.asarray(view), cfg, jnp.float32(0.0),
                  scheme="sparse")
    casts = _recording(monkeypatch)
    got = render_mrt(tb, W, H, pos, view, port.Config(**vars(cfg)), 0.0, scheme="sparse")
    # 2 bounces: primary, shadow 0, bounce 1, shadow 1
    assert [c[4] for c in casts] == [False, True, False, True]
    for ch in RNG_FREE:
        np.testing.assert_allclose(getattr(got, ch).numpy(), np.asarray(getattr(ref, ch)),
                                   atol=1e-5, rtol=0, err_msg=ch)
    assert got.alpha.numpy().mean() > 0.5 and got.glass.numpy().max() > 0
    w4 = IK.build_w4(world_geometry(tb), tb.id_buffer)[0]
    tie = torch.zeros(W * H, dtype=torch.bool)
    for o3, d3, ml, edge, any_hit in casts:
        tie |= tie_rays(w4, o3, d3, ml, edge, any_hit)
    tie = block_untile(tie, H, W, 32, 32).numpy()
    bad = (np.abs(got.color.numpy() - np.asarray(ref.color)) > 1e-5).any(axis=-1)
    print(f"color: {int(bad.sum())} of {W * H} pixels differ, {int(tie.sum())} pixels "
          f"with a ray in the tie set")
    assert bad.mean() <= 0.005 and not (bad & ~tie).any(), np.flatnonzero(bad & ~tie)


def _soup(path, n, seed):
    """An OBJ of n separate seeded triangles."""
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-5, 5, (3 * n, 3))
    normals = np.tile([[0.0, 1.0, 0.0]], (3 * n, 1))
    write_obj(path, verts, normals, np.arange(1, 3 * n + 1).reshape(n, 3))


@pytest.mark.parametrize("n,scheme", [(1024, "fused_split"), (1025, "kernel"),
                                      (4095, "kernel"), (4096, "sparse")])
def test_auto_rule_at_the_thresholds(tmp_path, n, scheme):
    """flexlight_tpu's rule on a chip (models/pathtracer.py:344-371):
    fused_split up to 1024 triangles, kernel below 4096, sparse from 4096."""
    _soup(tmp_path / "soup.obj", n, n)
    ttransform.reset_global_registry()
    scene, camera = port.Scene(), port.Camera()
    scene.primaryLightSources = [[0, 10, 0]]
    scene.queue.push(scene.import_obj(str(tmp_path / "soup.obj")))
    pt = PathTracer(8, 8, scene, camera, port.Config(), "cpu")
    assert pt.resolved_scheme() == scheme
    assert pt._buffers.id_buffer.shape[0] == n
    assert PathTracer(8, 8, scene, camera, port.Config(), "cpu",
                      scheme="sparse").resolved_scheme() == "sparse"


def test_dragon_stand_in_through_the_entry_points(tmp_path):
    """scenes.dragon on FlexLight(canvas, device="cpu"): 44,890 triangles,
    "auto" resolves to "sparse", and render_frame() (the plain versions on
    the CPU) gives a finite, lit frame; the bounce casts are sorted."""
    ttransform.reset_global_registry()
    engine, animate = dragon(0, tmp_path / "objects", device="cpu")
    engine.canvas = (16, 16)
    engine.config = port.Config(temporal=True, temporal_samples=2, filter=True,
                                antialiasing="fxaa", max_reflections=2)
    renderer = engine.renderer
    assert renderer.resolved_scheme() == "sparse"
    assert renderer._buffers.id_buffer.shape[0] == 44890
    animate(0.0)
    sorted_casts = []
    key = S._sorted
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(S, "_sorted", lambda *a: sorted_casts.append(1) or key(*a))
        frames = [renderer.render_frame() for _ in range(2)]
    assert len(sorted_casts) == 2 * 3               # per frame: 2 shadow + 1 bounce cast
    assert renderer.metrics.last["scheme"] == "sparse"
    for img in frames:
        assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.max() > 0
