"""The ranks of tests/test_torch_parallel.py and of the four-card test in
tests/test_torch_cuda.py: each layout is one spawn of ranks that join
through `multihost.initialize` (init_method file:// under the test's
tmp_path, so xdist workers never share a port), run several sharded
computations of the port and write their results to `<out>/rank<r>.pt`
for the test process to compare. The CPU layouts mesh over gloo, the
card layout over NCCL, one card a rank. No module of jax or
flexlight_tpu is imported here: the ranks run the port alone."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

SIZE_MRT = 16
SIZE_POST = 32


def scene(roughness=None, device="cpu"):
    """Cornell (flexlight_tpu_torch.scenes.cornell) on `device`: (buffers,
    camera); `roughness` overrides every object's."""
    from flexlight_tpu_torch import reset_global_registry
    from flexlight_tpu_torch.ops.buffers import build_scene_buffers
    from flexlight_tpu_torch.scenes import cornell

    reset_global_registry()
    e = cornell(device=device)
    if roughness is not None:
        for group in e.scene.queue:
            for obj in group:
                for part in (obj if isinstance(obj, list) else [obj]):
                    part.roughness = roughness
    return build_scene_buffers(e.scene, device), e.camera


def configs():
    from flexlight_tpu_torch import Config

    return {
        "mrt": Config(temporal=False, filter=False, antialiasing=None, max_reflections=2),
        "halo": Config(temporal=True, temporal_samples=2, filter=True, antialiasing="fxaa",
                       samples_per_ray=1, max_reflections=2),
        "taa": Config(temporal=False, filter=False, antialiasing="taa", samples_per_ray=1,
                      max_reflections=2),
        "aux": Config(temporal=False, filter=False, antialiasing=None, samples_per_ray=2,
                      max_reflections=3),
        "split": Config(temporal=False, filter=False, antialiasing=None, samples_per_ray=2,
                        max_reflections=2),
        "full": Config(temporal=True, temporal_samples=2, filter=True, antialiasing="fxaa",
                       samples_per_ray=2, max_reflections=2),
        "full_nofilter": Config(temporal=True, temporal_samples=2, filter=False,
                                antialiasing="fxaa", samples_per_ray=2, max_reflections=2),
    }


def key_plane(seed: int, h: int, w: int) -> torch.Tensor:
    """A packed originalColor plane: seeded bytes, a third of the blur
    keys (byte 3) zero."""
    g = torch.Generator().manual_seed(seed)
    b = torch.randint(0, 256, (h, w, 4), generator=g, dtype=torch.int64)
    b[..., 3] = torch.where(torch.rand((h, w), generator=g) < 0.33, 0, b[..., 3])
    packed = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    return torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed).to(torch.int32)


def frames(fn, cfg, n_frames: int, size: int, device="cpu"):
    """n_frames of fn(seed, temporal, taa) from fresh states on `device`,
    states carried."""
    from flexlight_tpu_torch.post.taa import taa_history
    from flexlight_tpu_torch.post.temporal import TemporalState

    temporal = TemporalState.create(cfg.temporal_samples, size, size, device)
    taa = taa_history(cfg.antialiasing, size, size, device)
    out = []
    for f in range(n_frames):
        display, temporal, taa = fn(float(f), temporal, taa)
        out.append((display, temporal, taa))
    return out


def _tile2(rank: int, res: dict) -> None:
    from flexlight_tpu_torch.parallel import halo as H
    from flexlight_tpu_torch.parallel import multihost
    from flexlight_tpu_torch.parallel import tile_sharding as T

    mesh = T.make_mesh(2, 1, "cpu")
    cfgs = configs()
    b, cam = scene()
    s = SIZE_MRT
    res["mrt"] = tuple(T.render_mrt_sharded(b, s, s, cam.position, cam.view_matrix(s, s),
                                            cfgs["mrt"], 0.0, mesh, scheme="kernel"))
    full = torch.arange(16 * 3 * 2, dtype=torch.float32).reshape(16, 3, 2)
    padded = H.exchange_halo(full[rank * 8:(rank + 1) * 8], 2, mesh)
    res["halo"] = H.all_gather(padded[None], mesh, "tile")
    res["is_leader"] = H.all_gather(torch.tensor([multihost.is_leader()]), mesh, "tile")

    s = SIZE_POST
    br, camr = scene(roughness=0.05)
    view = camr.view_matrix(s, s)
    res["halo_frames"] = frames(
        lambda seed, tmp, taa: T.frame_pipeline_sharded_halo(
            br, camr.position, view, seed, tmp, taa, s, s, cfgs["halo"], mesh, halo=16,
            check_halo=False), cfgs["halo"], 2, s)
    res["guard_frames"] = frames(
        lambda seed, tmp, taa: T.frame_pipeline_sharded_halo(
            br, camr.position, view, seed, tmp, taa, s, s, cfgs["halo"], mesh),
        cfgs["halo"], 1, s)
    bc, cc = scene()
    res["taa_frames"] = frames(
        lambda seed, tmp, taa: T.frame_pipeline_sharded_halo(
            bc, cc.position, cc.view_matrix(s, s), seed, tmp, taa, s, s, cfgs["taa"], mesh,
            halo=8), cfgs["taa"], 3, s)
    plane = key_plane(7, s, 40)
    strip = plane[rank * 16:(rank + 1) * 16]
    for ty in (8, 12, 32):
        res[f"tileize_{ty}"] = H.all_gather(
            T.tileize_blur_key_sharded(strip, rank * 16, s, mesh, ty=ty), mesh, "tile")
    mine = b if rank == 0 else type(b)(*(
        type(x)(*(torch.zeros_like(y) for y in x)) if isinstance(x, tuple) else
        torch.zeros_like(x) for x in b))
    got = multihost.broadcast_scene(mine)
    res["broadcast"] = [bool(torch.equal(x, y)) for x, y in
                        zip(_leaves(got), _leaves(b))]


def _leaves(t):
    for x in t:
        if isinstance(x, tuple):
            yield from _leaves(x)
        else:
            yield x


def _tile2x2(rank: int, res: dict) -> None:
    from flexlight_tpu_torch.parallel import tile_sharding as T

    mesh = T.make_mesh(2, 2, "cpu")
    cfgs = configs()
    s = SIZE_MRT
    b, cam = scene(roughness=0.4)
    view = cam.view_matrix(s, s)
    res["aux"] = tuple(T.render_mrt_sharded(b, s, s, cam.position, view, cfgs["aux"], 0.0,
                                            mesh, scheme="kernel"))
    b, cam = scene()
    view = cam.view_matrix(s, s)
    res["split"] = tuple(T.render_mrt_sharded(b, s, s, cam.position, view, cfgs["split"], 0.0,
                                              mesh, scheme="fused_split"))
    for name in ("full", "full_nofilter"):
        res[name] = frames(
            lambda seed, tmp, taa, name=name: T.frame_pipeline_sharded(
                b, cam.position, view, seed, tmp, taa, s, s, cfgs[name], mesh),
            cfgs[name], 1, s)


def _cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, (tuple, list)):
        return type(x)(*map(_cpu, x)) if hasattr(x, "_fields") else type(x)(map(_cpu, x))
    return x


def _cuda2x2(rank: int, res: dict) -> None:
    """Four cards, one rank each, on a "cuda" (NCCL) 2 x 2 mesh: the
    sample-sharded MRT, the strip-sharded halo pipeline (on the tile
    axis), the halo exchange and the scene broadcast, all on the card."""
    from flexlight_tpu_torch.parallel import halo as H
    from flexlight_tpu_torch.parallel import multihost
    from flexlight_tpu_torch.parallel import tile_sharding as T

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    mesh = T.make_mesh(2, 2, "cuda")
    res["backend"] = dist.get_backend(mesh.get_group("tile"))
    cfgs = configs()
    s = SIZE_MRT
    b, cam = scene(roughness=0.4, device=dev)
    res["aux"] = _cpu(tuple(T.render_mrt_sharded(b, s, s, cam.position,
                                                 cam.view_matrix(s, s), cfgs["aux"], 0.0,
                                                 mesh, scheme="kernel")))
    s = SIZE_POST
    br, camr = scene(roughness=0.05, device=dev)
    view = camr.view_matrix(s, s)
    res["halo_frames"] = _cpu(frames(
        lambda seed, tmp, taa: T.frame_pipeline_sharded_halo(
            br, camr.position, view, seed, tmp, taa, s, s, cfgs["halo"], mesh, halo=16,
            check_halo=False), cfgs["halo"], 2, s, dev))
    ti = mesh.get_local_rank("tile")
    full = torch.arange(16 * 3 * 2, dtype=torch.float32, device=dev).reshape(16, 3, 2)
    padded = H.exchange_halo(full[ti * 8:(ti + 1) * 8], 2, mesh)
    res["halo_device"] = str(padded.device)
    res["halo"] = H.all_gather(padded[None], mesh, "tile").cpu()
    mine = b if rank == 0 else type(b)(*(
        type(x)(*(torch.zeros_like(y) for y in x)) if isinstance(x, tuple) else
        torch.zeros_like(x) for x in b))
    got = multihost.broadcast_scene(mine)
    res["broadcast"] = [bool(torch.equal(x, y)) for x, y in
                        zip(_leaves(got), _leaves(b))]


LAYOUTS = {"tile2": (2, _tile2), "tile2x2": (4, _tile2x2), "cuda2x2": (4, _cuda2x2)}


def run(rank: int, layout: str, init_file: str, out_dir: str) -> None:
    """One rank of `layout`: join the group, compute, write its results."""
    from flexlight_tpu_torch.parallel import multihost

    world, fn = LAYOUTS[layout]
    torch.set_num_threads(1)
    multihost.initialize(f"file://{init_file}", world, rank)
    res = {}
    fn(rank, res)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    # a barrier on a host tensor, which gloo carries in every layout
    dist.all_reduce(torch.zeros(1))
    dist.destroy_process_group()


def spawn(layout: str, tmp_dir) -> list:
    """Run `layout` on its ranks (start method spawn); a rank that fails
    fails the spawn. Returns each rank's results."""
    import torch.multiprocessing as mp

    world = LAYOUTS[layout][0]
    init_file = os.path.join(str(tmp_dir), "init")
    mp.start_processes(run, args=(layout, init_file, str(tmp_dir)), nprocs=world,
                       start_method="spawn")
    return [torch.load(os.path.join(str(tmp_dir), f"rank{r}.pt"), weights_only=False)
            for r in range(world)]
