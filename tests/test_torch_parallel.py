"""The port's multi-device rendering (flexlight_tpu_torch/parallel/ on
torch.distributed) against its one-process frames and against
flexlight_tpu's sharded functions on the 8-device virtual mesh
(tests/conftest.py): the nine tests of tests/test_parallel.py, and
render_mrt's strip and sample-slice arguments against flexlight_tpu's.

The ranks run in spawned gloo processes, one spawn per layout (tile 2;
tile 2 x sample 2) that computes several results
(tests/torch_parallel_ranks.py); the cases here read them. Tolerances,
with their reasons:
- tile sharding renders each strip's rays bit for bit (render_mrt's row
  index is the whole frame's), and the halo pipeline's passes read the
  same values (zero rows at the image border, as texelFetch's): MRTs,
  displays and states identical to the one-process ones; a blur key of a
  tile that straddles a strip border sums in another order and may move
  a quantized byte (`tileize_blur_key_sharded`), none does here;
- sample sharding sums each slice's colour, already scaled by 1 / spp:
  1e-4 (tests/test_parallel.py's), the other channels at its rtol 1e-4 /
  atol 1e-5, and the full pipeline with its bound (no value off by more
  than 1.5 / 255, < 2% off by more than 1e-6);
- flexlight_tpu's functions on its mesh: the halo exchange and the
  blur-key tiles exactly; render_mrt's strip and slice, run op by op,
  to 1e-5 on every pixel none of whose casts is a knife edge
  (tests/test_torch_traverse.py `knife_edge_rays`)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from flexlight_tpu.parallel import halo as JH  # noqa: E402
from flexlight_tpu.parallel import tile_sharding as JT  # noqa: E402
import flexlight_tpu_torch as port  # noqa: E402
from flexlight_tpu_torch.models.pathtracer import frame_pipeline  # noqa: E402
from flexlight_tpu_torch.ops import intersect_kernel as IK  # noqa: E402
from flexlight_tpu_torch.ops import pathtrace as tpt  # noqa: E402
from flexlight_tpu_torch.ops.buffers import buffers_from_numpy  # noqa: E402
from flexlight_tpu_torch.ops.geometry import world_geometry  # noqa: E402
from flexlight_tpu_torch.ops.intersect import BIAS, POW32  # noqa: E402
from flexlight_tpu_torch.parallel import multihost  # noqa: E402
from flexlight_tpu_torch.parallel import tile_sharding as T  # noqa: E402
from flexlight_tpu_torch.post.filter_kernel import (tileize_blur_key_packed,  # noqa: E402
                                                    unpack_rgba8)
from tests import torch_parallel_ranks as W  # noqa: E402
from tests.scenes import cornell_scene  # noqa: E402
from tests.test_torch_traverse import knife_edge_rays  # noqa: E402

CFGS = W.configs()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's torch work (the spawned ranks
    run with one each): under xdist the workers share the cores, and
    torch's spinning thread pool then takes ~30x longer on these small
    frames."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tile2(tmp_path_factory):
    return W.spawn("tile2", tmp_path_factory.mktemp("tile2"))


@pytest.fixture(scope="module")
def tile2x2(tmp_path_factory):
    return W.spawn("tile2x2", tmp_path_factory.mktemp("tile2x2"))


def _one_process(name, roughness=None, n_frames=1, size=W.SIZE_POST, scheme="kernel"):
    b, cam = W.scene(roughness)
    view = cam.view_matrix(size, size)
    return W.frames(lambda seed, tmp, taa: frame_pipeline(
        b, cam.position, view, seed, tmp, taa, size, size, CFGS[name], scheme=scheme),
        CFGS[name], n_frames, size)


def _one_mrt(name, roughness=None, scheme="kernel"):
    b, cam = W.scene(roughness)
    s = W.SIZE_MRT
    return tpt.render_mrt(b, s, s, cam.position, cam.view_matrix(s, s), CFGS[name], 0.0,
                          scheme=scheme)


def _identical(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_mrt_matches_one_process(tile2, rank):
    """Tile 2: every rank holds the whole MRT, identical to one process's."""
    one = _one_mrt("mrt")
    got = tile2[rank]["mrt"]
    assert got[0].shape == (W.SIZE_MRT ** 2, 3) and float(one.alpha.mean()) > 0.5
    for field, a, b in zip(one._fields, got, one):
        assert torch.equal(a, b), field


def test_halo_exchange_matches_padding(tile2):
    """Each strip with its neighbours' border rows (zeros at the image
    border), as numpy pads it and as flexlight_tpu's ppermute exchange
    gives it on a 2-tile mesh."""
    full = np.arange(16 * 3 * 2, dtype=np.float32).reshape(16, 3, 2)
    got = tile2[0]["halo"].numpy()
    assert got.shape == (2, 12, 3, 2)
    pad = np.concatenate([np.zeros((2, 3, 2), np.float32), full,
                          np.zeros((2, 3, 2), np.float32)])
    for i in range(2):
        np.testing.assert_array_equal(got[i], pad[i * 8:i * 8 + 12])

    def fn(strip):
        return jax.lax.all_gather(JH.exchange_halo(strip, 2, "tile"), "tile", axis=0,
                                  tiled=True)

    ref = jax.shard_map(fn, mesh=JT.make_mesh(2, 1), in_specs=P("tile"), out_specs=P(),
                        check_vma=False)(jnp.asarray(full))
    np.testing.assert_array_equal(got.reshape(24, 3, 2), np.asarray(ref))


@pytest.mark.parametrize("frame", [0, 1])
def test_sharded_halo_pipeline_matches_one_process(tile2, frame):
    """The strip-sharded temporal + 3+3+final filter + FXAA pipeline
    (32 x 32, 16-row strips, halo 16, check_halo=False: the low-roughness
    scene's blur stays inside it) against one process, two frames with
    the temporal ring carried: displays and rings identical on both
    ranks."""
    ref = _one_process("halo", roughness=0.05, n_frames=2)[frame]
    for rank in (0, 1):
        display, state, _ = tile2[rank]["halo_frames"][frame]
        assert torch.equal(display, ref[0]), int((display != ref[0]).any(-1).sum())
        assert _identical(state, ref[1])
    assert float(ref[0].max()) > 0.0


def test_exactness_guard_takes_the_gather_post(tile2):
    """With check_halo the config's worst-case reach (42 rows, the first
    pass's disc) exceeds the 16-row strips, so the frame takes the
    all-gather post of frame_pipeline_sharded: the one-process frame."""
    assert T.required_post_halo(CFGS["halo"]) == 42 > W.SIZE_POST // 2
    ref = _one_process("halo", roughness=0.05)[0]
    display, state, _ = tile2[0]["guard_frames"][0]
    assert torch.equal(display, ref[0]) and _identical(state, ref[1])


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_sharded_halo_taa_matches_one_process(tile2, frame):
    """TAA in the strip-sharded pipeline (the 3x3 clamp over a 1-row
    halo, the history strips local), three frames with the history
    carried: displays and histories identical."""
    ref = _one_process("taa", n_frames=3)[frame]
    display, _, taa = tile2[0]["taa_frames"][frame]
    assert torch.equal(display, ref[0])
    assert torch.equal(taa.history, ref[2].history)


@pytest.mark.parametrize("rank", [0, 2])
def test_sample_sharded_aux_matches_sequential(tile2x2, rank):
    """Tile 2 x sample 2, spp 2, roughness 0.4, 3 bounces: every MRT
    channel against the one-process sample loop (sums, last sample, the
    running min of firstRayLength, original_w folded from the combined raw
    channels)."""
    one = _one_mrt("aux", roughness=0.4)
    got = tile2x2[rank]["aux"]
    np.testing.assert_allclose(got[0].numpy(), one.color.numpy(), rtol=0, atol=1e-4)
    for field, a, b in list(zip(one._fields, got, one))[1:]:
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5, err_msg=field)
    assert float(one.original_w.max()) > 0.0 and float(one.glass.max()) >= 0.0


def test_sample_sharded_full_pipeline_matches_one_process(tile2x2):
    """frame_pipeline_sharded on the 2 x 2 mesh (temporal + filter + FXAA,
    spp 2) against one process's frame."""
    ref = _one_process("full", size=W.SIZE_MRT)[0][0]
    got = tile2x2[0]["full"][0][0]
    diff = (got - ref).abs()
    assert float((diff > 1.5 / 255.0).float().mean()) == 0.0, float(diff.max())
    assert float((diff > 1e-6).float().mean()) < 0.02


def test_sharded_full_pipeline_2d_mesh(tile2x2):
    """frame_pipeline_sharded on the 2 x 2 mesh without the filter: a
    finite, lit frame of the right shape on every rank, within the same
    bound of one process's."""
    ref = _one_process("full_nofilter", size=W.SIZE_MRT)[0][0]
    for rank in range(4):
        out = tile2x2[rank]["full_nofilter"][0][0]
        assert out.shape == (W.SIZE_MRT, W.SIZE_MRT, 3)
        assert bool(torch.isfinite(out).all()) and float(out.max()) > 0.0
        assert float(((out - ref).abs() > 1.5 / 255.0).float().mean()) == 0.0


def test_sharded_fused_split_matches_one_process(tile2x2):
    """The fused_split scheme (PRE / POST's plain versions here) under
    the 2 x 2 mesh: every MRT channel identical to one process's."""
    one = _one_mrt("split", scheme="fused_split")
    for field, a, b in zip(one._fields, tile2x2[3]["split"], one):
        assert torch.equal(a, b), field


def test_multihost_single_process_identity():
    """One process: initialize() is a no-op, this process leads, and the
    scene broadcast hands back the local buffers."""
    multihost.initialize()
    assert multihost.is_leader()
    b, _ = W.scene()
    assert multihost.broadcast_scene(b) is b
    from flexlight_tpu_torch import reset_global_registry
    from flexlight_tpu_torch.scenes import cornell

    reset_global_registry()
    e = cornell(device="cpu")
    out = multihost.build_and_broadcast(e.scene, "cpu")
    assert torch.equal(out.geometry, b.geometry)
    with pytest.raises(ValueError, match="needs"):
        multihost.initialize(num_processes=2)


def test_broadcast_scene_gives_the_leaders_buffers(tile2):
    """Two ranks: rank 1 passes zeroed buffers and gets rank 0's, tensor by
    tensor (the atlas tables too); only rank 0 leads."""
    assert tile2[1]["broadcast"] and all(tile2[1]["broadcast"])
    assert len(tile2[1]["broadcast"]) == 20
    assert tile2[0]["is_leader"].tolist() == [True, False]


@pytest.mark.parametrize("ty", [8, 12, 32])
def test_tileize_blur_key_sharded(tile2, ty):
    """The fast mode's blur key on 16-row strips of a seeded 32 x 40
    plane: tile rows of 8 meet the strip border, of 12 and 32 straddle it
    (their sums add the strips' partial sums). Identical to the one-process
    tileize here, and (tile rows of 12) to flexlight_tpu's psum form on
    its 2-tile mesh."""
    plane = W.key_plane(7, W.SIZE_POST, 40)
    got = tile2[0][f"tileize_{ty}"]
    assert torch.equal(got, tileize_blur_key_packed(plane, ty=ty))
    assert not torch.equal(got, plane)
    if ty != 12:
        return
    ocolor = jnp.asarray(unpack_rgba8(plane).numpy())

    def fn(strip):
        row0 = jax.lax.axis_index("tile") * 16
        out = JT.tileize_blur_key_sharded(strip, row0, W.SIZE_POST, "tile", ty=ty)
        return jax.lax.all_gather(out, "tile", axis=0, tiled=True)

    ref = jax.shard_map(fn, mesh=JT.make_mesh(2, 1), in_specs=P("tile"), out_specs=P(),
                        check_vma=False)(ocolor)
    np.testing.assert_array_equal(unpack_rgba8(got).numpy(), np.asarray(ref))


def test_required_post_halo_matches_flexlight_tpu():
    from flexlight_tpu import Config as JConfig

    for kw in (dict(filter=True), dict(filter=True, first_passes=0),
               dict(filter=True, first_passes=0, second_passes=0, antialiasing=None),
               dict(filter=False, antialiasing="fxaa"), dict(filter=False, antialiasing="taa"),
               dict(filter=False, antialiasing=None)):
        assert T.required_post_halo(port.Config(**kw)) == JT.required_post_halo(JConfig(**kw))


def test_make_mesh_needs_an_initialised_world():
    with pytest.raises(RuntimeError, match="need 2 ranks"):
        T.make_mesh(2, 1)


def test_render_mrt_strip_and_slice_match_flexlight_tpu(monkeypatch):
    """render_mrt's row0 / rows, sample_offset / local_samples and
    with_raw_aux on both packages, op by op: cornell at 16 x 16, the
    strip of rows 8-15, sample 1 of spp 2, counter RNG, 2 bounces, scheme
    "scan"; the MRT and the raw (originalRMEx, firstRayLength)."""
    from flexlight_tpu import Config
    from flexlight_tpu.ops import buffers as jbuf
    from flexlight_tpu.ops.pathtrace import render_mrt as jrender

    size = 16
    scene, camera = cornell_scene()
    jb = jbuf.build_scene_buffers(scene)
    tb = buffers_from_numpy(jax.tree.map(np.asarray, jb), "cpu")
    cfg = Config(temporal=False, filter=False, antialiasing=None, max_reflections=2,
                 samples_per_ray=2, rng="counter")
    view = camera.view_matrix(size, size)
    args = dict(row0=8, rows=8, sample_offset=1, local_samples=1, with_raw_aux=True)
    ref, ref_raw = jrender(jb, size, size, jnp.asarray(camera.position), jnp.asarray(view),
                           cfg, jnp.float32(0.0), scheme="scan", **args)
    casts = []
    real = tpt.scheme_casts

    def recording(*a):
        traverse, shadow = real(*a)

        def closest(o3, d3, alive=None, edge=BIAS, bounce=False):
            casts.append((False, o3, d3, torch.full_like(o3[0], POW32), edge))
            return traverse(o3, d3, alive=alive, edge=edge, bounce=bounce)

        def any_hit(o3, d3, max_len, alive=None, bounce=False):
            casts.append((True, o3, d3, max_len, BIAS))
            return shadow(o3, d3, max_len, alive=alive, bounce=bounce)

        return closest, any_hit

    monkeypatch.setattr(tpt, "scheme_casts", recording)
    got, got_raw = tpt.render_mrt(tb, size, size, camera.position, view,
                                  port.Config(**vars(cfg)), 0.0, scheme="scan", **args)
    w4 = IK.build_w4(world_geometry(tb), tb.id_buffer)[0]
    n = 8 * size
    tie = torch.zeros(n, dtype=torch.bool)
    for any_hit, o3, d3, max_len, edge in casts:
        tie |= knife_edge_rays(w4, tuple(c.contiguous() for c in o3),
                               tuple(c.contiguous() for c in d3), max_len.contiguous(), edge,
                               any_hit)
    assert got.color.shape == (n, 3) and tie.float().mean() <= 0.15
    pairs = list(zip(ref._fields, ref, got)) + [("raw_rme", ref_raw[0], got_raw[0]),
                                                 ("raw_frl", ref_raw[1], got_raw[1])]
    for field, a, b in pairs:
        a = np.asarray(a).reshape(n, -1)
        b = b.numpy().reshape(n, -1)
        assert float(np.abs(a - b).max(axis=-1)[~tie.numpy()].max()) <= 1e-5, field
    assert float(got.alpha.mean()) > 0.5


@pytest.mark.parametrize("scheme", ["kernel", "sparse", "fused_split", "fused", "mxu",
                                    "clustered", "scan"])
def test_strips_and_slices_recombine(scheme):
    """On every scheme (cornell, 16 x 16, spp 2, 2 bounces): two 8-row
    strips are the whole frame's rows bit for bit, and two one-sample
    slices recombine into the whole sample loop as the sharded combine
    takes them (colours summed, the last slice's channels, rme summed and
    firstRayLength's min from the raw channels)."""
    scene, camera = cornell_scene()
    from flexlight_tpu.ops import buffers as jbuf

    tb = buffers_from_numpy(jax.tree.map(np.asarray, jbuf.build_scene_buffers(scene)), "cpu")
    size = 16
    cfg = port.Config(temporal=False, filter=False, antialiasing=None, max_reflections=2,
                      samples_per_ray=2)
    view = camera.view_matrix(size, size)

    def mrt(**kw):
        return tpt.render_mrt(tb, size, size, camera.position, view, cfg, 0.0, scheme=scheme,
                              tile=64, **kw)

    whole = mrt()
    strips = [mrt(row0=r0, rows=8) for r0 in (0, 8)]
    for field, w, a, b in zip(whole._fields, whole, *strips):
        assert torch.equal(torch.cat([a, b]), w), field
    (m0, raw0), (m1, raw1) = (mrt(sample_offset=j, local_samples=1, with_raw_aux=True)
                              for j in (0, 1))
    assert torch.equal(m0.color + m1.color, whole.color)
    for field in ("original_color", "original_id_w", "location_id", "alpha"):
        assert torch.equal(getattr(m1, field), getattr(whole, field)), field
    cov = whole.alpha > 0
    folded = torch.where(cov, torch.minimum(raw0[0] + raw1[0], torch.minimum(raw0[1], raw1[1]))
                         + tpt.INV_255, 0.0)
    np.testing.assert_allclose(folded.numpy(), whole.original_w.numpy(), rtol=1e-6, atol=1e-7)
