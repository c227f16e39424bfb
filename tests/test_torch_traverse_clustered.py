"""The port's clustered casts (ops/traverse_clustered.py, plain float32
PyTorch) against flexlight_tpu's (ops/traverse_clustered.py) on the same
inputs: the four tests of tests/test_traverse_clustered.py, on a seeded
stand-in mesh (flexlight_tpu's tests skip without the reference's
monke.obj, which the repository does not hold), and scheme="clustered" on
both renderers.

The two packages sum the Moeller-Trumbore products in other orders, so a
ray may be decided apart where it is a knife edge
(tests/test_torch_traverse.py `knife_edge_rays`); on every other ray the
triangle ids are identical, s agrees to 1e-5 and u / v to 1e-5 plus
VALUE_ULPS of their float32 rounding bounds (tests/test_torch_sparse.py
`rounding`: ratios of sums with cancellation, summed in other orders).
The port's
products are the sparse casts' (ops.intersect_sparse_kernel
`record_products`), so a clustered frame is the sparse frame but for the
rays whose two nearest triangles lie within rounding of each other (each
scheme breaks such a tie in its own order)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from flexlight_tpu.ops import traverse_clustered as JC  # noqa: E402
import flexlight_tpu_torch as port  # noqa: E402
from flexlight_tpu_torch.models.pathtracer import PathTracer  # noqa: E402
from flexlight_tpu_torch.models.rasterizer import Rasterizer  # noqa: E402
from flexlight_tpu_torch.ops import intersect_kernel as IK  # noqa: E402
from flexlight_tpu_torch.ops import traverse_clustered as TC  # noqa: E402
from flexlight_tpu_torch.ops import traverse_mxu as TM  # noqa: E402
from flexlight_tpu_torch.ops.intersect import BIAS, POW32  # noqa: E402
from flexlight_tpu_torch.scenes import stand_in_mesh, write_obj  # noqa: E402
from tests.test_torch_sparse import VALUE_ULPS, rounding  # noqa: E402
from tests.test_torch_traverse import knife_edge_rays  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's torch work: under xdist the
    workers share the cores, and torch's spinning thread pool then takes
    many times longer on these small casts."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    """A seeded stand-in mesh of 1,392 triangles as world geometry rows
    (vertices in columns 0-9), the drawables in Morton order of their
    centroids (spatially coherent clusters, as a BVH's order gives)."""
    v, _, tris = stand_in_mesh(np.random.default_rng(3), 24, 30, (3.0, 2.0, 2.0), 0.0, 0.15)
    t = tris.shape[0]
    wg = np.zeros((t, 12), np.float32)
    wg[:, 0:9] = v[tris - 1].reshape(t, 9)
    c = wg[:, 0:9].reshape(t, 3, 3).mean(axis=1)
    q = ((c - c.min(axis=0)) / np.ptp(c, axis=0) * 1023).astype(np.int64)
    code = sum(((q[:, a] >> b) & 1) << (3 * b + a) for a in range(3) for b in range(10))
    ids = np.argsort(code, kind="stable").astype(np.int32)
    w4 = IK.build_w4(torch.from_numpy(wg), torch.from_numpy(ids))[0]
    return dict(wg=wg, ids=ids, w4=w4)


def _clusters(mesh, size):
    return (JC.build_clusters(jnp.asarray(mesh["wg"]), jnp.asarray(mesh["ids"]),
                              cluster_size=size),
            TC.build_clusters(torch.from_numpy(mesh["wg"]), torch.from_numpy(mesh["ids"]),
                              cluster_size=size))


def _rays(n, seed=0, origin_base=(0.0, 0.0, -8.0), spread=1.0):
    """tests/test_traverse_clustered.py's rays, toward the mesh; `spread`
    scales their sideways components."""
    rng = np.random.default_rng(seed)
    origin = np.tile(np.asarray(origin_base, np.float32), (n, 1))
    origin += rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 0:2] *= spread
    d[:, 2] = np.abs(d[:, 2]) + 2.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return origin, d


def _soa(x):
    return tuple(torch.from_numpy(np.ascontiguousarray(x[:, c])) for c in range(3))


def _check_closest(mesh, ref, got, o, d):
    n = o.shape[0]
    tie = knife_edge_rays(mesh["w4"], _soa(o), _soa(d), torch.full((n,), POW32), BIAS,
                          False).numpy()
    jt, tt = np.asarray(ref.triangle), got.triangle.numpy()
    assert (jt[~tie] == tt[~tie]).all(), np.nonzero((jt != tt) & ~tie)
    assert tie.mean() <= 0.05 and 0.3 < (tt >= 0).mean()
    same = (jt == tt) & (tt >= 0)
    np.testing.assert_allclose(got.suv.numpy()[same, 0], np.asarray(ref.suv)[same, 0],
                               rtol=1e-5, atol=1e-5)
    _, _, _, _, _, e_u, e_v, _ = rounding(mesh["w4"], _soa(o), _soa(d))
    col = torch.from_numpy(np.maximum(tt, 0)).long()[:, None]
    for k, e in ((1, e_u), (2, e_v)):
        a, b = got.suv.numpy()[same, k], np.asarray(ref.suv)[same, k]
        e = torch.gather(e, 1, col)[:, 0].numpy()[same]
        assert (np.abs(a - b) - (1e-5 + 1e-5 * np.abs(b)) <= VALUE_ULPS * e).all(), k
    # every triangle at once (the mxu cast): the same hits off the knife edges
    full = TM.traverse_mxu(TM.build_tri_matrix(torch.from_numpy(mesh["wg"]),
                                               torch.from_numpy(mesh["ids"])),
                           torch.from_numpy(mesh["ids"]), torch.from_numpy(o),
                           torch.from_numpy(d))
    assert (full.triangle.numpy()[~tie] == tt[~tie]).all()


def _live_chunks(tc, o, d, block, group, k_cand):
    """Each group's live chunks, from the port's own phase A (unsorted rays
    are enough to see that a group skips chunks)."""
    hit, _ = TC._cluster_hits(tc, torch.from_numpy(o).reshape(-1, block * group, 3),
                              torch.from_numpy(d).reshape(-1, block * group, 3), POW32)
    return -(-hit.any(dim=1).sum(dim=-1) // k_cand)


def test_clustered_matches_coherent(mesh):
    """Coherent rays: each group's union holds 26 of the 44 clusters, so
    with k_cand 8 it scans 4 of 6 chunks and skips the rest."""
    jc, tc = _clusters(mesh, 32)
    o, d = _rays(256, spread=0.05)
    ref = JC.traverse_clustered(jc, jnp.asarray(o), jnp.asarray(d), block=64, k_cand=8,
                                group=2)
    got = TC.traverse_clustered(tc, torch.from_numpy(o), torch.from_numpy(d), block=64,
                                k_cand=8, group=2)
    _check_closest(mesh, ref, got, o, d)
    live = _live_chunks(tc, o, d, 64, 2, 8)
    assert tc.w.shape[0] == 44 and 0 < int(live.min()) and int(live.max()) < 6


@pytest.mark.parametrize("k_cand,edge", [(2, BIAS), (5, -BIAS)])
def test_clustered_several_chunks(mesh, k_cand, edge):
    """A small k_cand makes a group scan several chunks (the reference's
    overflow case), the last padded past K; the relaxed primary edge."""
    jc, tc = _clusters(mesh, 32)
    o, d = _rays(128, seed=1)
    ref = JC.traverse_clustered(jc, jnp.asarray(o), jnp.asarray(d), block=32, k_cand=k_cand,
                                group=2, edge=edge)
    got = TC.traverse_clustered(tc, torch.from_numpy(o), torch.from_numpy(d), block=32,
                                k_cand=k_cand, group=2, edge=edge)
    n = o.shape[0]
    tie = knife_edge_rays(mesh["w4"], _soa(o), _soa(d), torch.full((n,), POW32), edge,
                          False).numpy()
    jt, tt = np.asarray(ref.triangle), got.triangle.numpy()
    assert (jt[~tie] == tt[~tie]).all()
    assert int(_live_chunks(tc, o, d, 32, 2, k_cand).max()) >= 3


def test_clustered_shadow_matches(mesh):
    jc, tc = _clusters(mesh, 32)
    o, d = _rays(256, seed=2)
    max_len = np.random.default_rng(4).uniform(4.0, 12.0, 256).astype(np.float32)
    ref = JC.shadow_clustered(jc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(max_len),
                              block=64, k_cand=16, group=2)
    got = TC.shadow_clustered(tc, *(torch.from_numpy(x) for x in (o, d, max_len)), block=64,
                              k_cand=16, group=2)
    tie = knife_edge_rays(mesh["w4"], _soa(o), _soa(d), torch.from_numpy(max_len), BIAS,
                          True).numpy()
    ref, got = np.asarray(ref), got.numpy()
    assert (ref[~tie] == got[~tie]).all()
    assert tie.mean() <= 0.05 and 0.05 < got.mean() < 0.95


def test_cluster_build_shapes(mesh):
    jc, tc = _clusters(mesh, 64)
    t = mesh["ids"].shape[0]
    k = -(-t // 64)
    assert tc.w.shape == (k, 16, 256)
    assert tc.aabb_min.shape == (k, 3) and tc.tri_slots.shape == (k, 64)
    for name in ("aabb_min", "aabb_max", "tri_slots"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)))
    np.testing.assert_allclose(tc.w.numpy(), np.asarray(jc.w), rtol=1e-6, atol=1e-5)
    # AABBs contain their triangles; padded slots are -1 with empty boxes
    first = mesh["wg"][mesh["ids"][:64], 0:9].reshape(-1, 3)
    assert (tc.aabb_min[0].numpy() <= first.min(axis=0)).all()
    assert (tc.aabb_max[0].numpy() >= first.max(axis=0)).all()
    assert (tc.tri_slots[-1, t - (k - 1) * 64:] == -1).all()


def _mesh_engine(path, renderer):
    """The dragon stand-in's materials (a glass mesh on a metallic plane
    under one light) on a port FlexLight, renderer chosen."""
    port.reset_global_registry()
    e = port.FlexLight((32, 32), device="cpu")
    scene, camera = e.scene, e.camera
    camera.x, camera.y, camera.z = -6, 5, -6
    camera.fx, camera.fy = -0.8, 0.4
    scene.primaryLightSources = [[20, 30, 10]]
    scene.primary_light_sources[0].intensity = 5000
    plane = scene.Plane([-50, -1, -50], [50, -1, -50], [50, -1, 50], [-50, -1, 50])
    plane.roughness = 1
    plane.metallicity = 0.8
    scene.queue.push(plane)
    obj = scene.import_obj(path)
    obj.roughness = 0
    obj.metallicity = 1
    obj.translucency = 1
    obj.ior = 1.5
    scene.queue.push(obj)
    scene.queue[:] = [scene.generate_bvh()]
    e.config = port.Config(temporal=False, filter=False, antialiasing=None, max_reflections=3,
                           rng="counter")
    e.renderer = renderer
    return e


@pytest.mark.parametrize("renderer", ["pathtracer", "rasterizer"])
def test_clustered_frames_against_sparse(tmp_path, renderer):
    """Both renderers on scheme="clustered" against scheme="sparse" on a
    2,066-triangle glass mesh (32 clusters, block-tiled rays in the path
    tracer), through render_frame: every value of a pixel identical but on
    the few pixels whose casts found two triangles within rounding of
    each other."""
    path = tmp_path / "mesh.obj"
    write_obj(path, *stand_in_mesh(np.random.default_rng(5), 24, 44, (3.0, 2.0, 2.0), 1.0,
                                   0.15))
    frames = {}
    for scheme in ("clustered", "sparse"):
        e = _mesh_engine(str(path), renderer)
        e.renderer.scheme = scheme
        assert isinstance(e.renderer, PathTracer if renderer == "pathtracer" else Rasterizer)
        frames[scheme] = e.renderer.render_frame()
        assert e.renderer.metrics.last["scheme"] == scheme
    assert e.renderer._buffers.id_buffer.shape[0] == 2066
    differ = (frames["clustered"] != frames["sparse"]).any(axis=-1)
    assert differ.mean() <= 0.02, differ.mean()
    assert np.isfinite(frames["clustered"]).all() and frames["clustered"].max() > 0.0
