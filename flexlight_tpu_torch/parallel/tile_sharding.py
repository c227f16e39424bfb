"""Multi-device rendering: image-tile x sample sharding over a device mesh
(flexlight_tpu/parallel/tile_sharding.py on torch.distributed).

The mesh is a 2-D torch DeviceMesh over the initialised process group
(`make_mesh`), one rank a mesh cell:

- "tile": horizontal image strips. Each rank traces its own rows
  (render_mrt's row0 / rows) against the whole scene; strips are
  assembled with an all-gather.
- "sample": the per-pixel sample loop (glsl:610-614) split across ranks
  (render_mrt's sample_offset / local_samples), combined as the
  reference's sequential loop combines its shader globals.

flexlight_tpu's collectives map as: axis_index -> the rank's mesh
coordinate, psum -> all_reduce(SUM) on the axis group, pmin ->
all_reduce(MIN), all_gather(tiled=True) -> all_gather and a concatenation
in coordinate order, ppermute -> send / receive (parallel.halo). The
mesh's device type chooses the transport ("cpu": gloo through host
copies, "cuda": NCCL); the render device is the caller's, where the
scene buffers live. A rank that fails raises: no collective is retried
and no result falls back to another device."""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import KERNELS
from ..ops.pathtrace import INV_255, MRT, render_mrt
from ..post.chain import postprocess_mrt
from ..post.taa import TAAState, neighborhood_clamp, taa_apply
from ..post.temporal import TemporalState
from .halo import all_gather, all_reduce, broadcast, exchange_halo, mesh_axis, with_halo

# the disc filters' per-pixel stencil scale ranges (post/filters.py: the
# first pass (1 + w)^2 * 3.5 with w in [0, 1], the second 1 + 2 tanh(.),
# the final 0.7 + 2 tanh(.); flexlight_tpu/post/filter_kernel.py:69-71)
FIRST_BOUNDS = (3.5, 14.0)
SECOND_BOUNDS = (1.0, 3.0)
FINAL_BOUNDS = (0.7, 2.7)


def make_mesh(n_tile: int, n_sample: int = 1, device_type: str = "cpu"):
    """The ("tile", "sample") DeviceMesh of n_tile x n_sample ranks over
    the initialised world (every rank calls it). `device_type` is the
    transport's: "cpu" (gloo) or "cuda" (NCCL, one card a rank)."""
    from torch.distributed.device_mesh import init_device_mesh

    need = n_tile * n_sample
    if not dist.is_initialized():
        raise RuntimeError(f"need {need} ranks: torch.distributed is not initialised "
                           "(parallel.multihost.initialize)")
    have = dist.get_world_size()
    if have < need:
        raise ValueError(f"need {need} ranks, have {have}")
    if have > need:
        raise ValueError(f"a {n_tile} x {n_sample} mesh takes every rank of the world: "
                         f"{have} ranks")
    return init_device_mesh(device_type, (n_tile, n_sample), mesh_dim_names=("tile", "sample"))


def _stencil_reach(stencil: np.ndarray, smax: float) -> int:
    """The farthest row or column a scaled stencil tap reaches:
    max |trunc(s * smax)| in float32, as the taps truncate."""
    prod = stencil.astype(np.float32).reshape(-1) * np.float32(smax)
    return int(np.abs(np.trunc(prod)).max())


def required_post_halo(config) -> int:
    """Worst-case cross-pixel reach of any single lifted post pass: the
    denoise blur's offset trunc(stencil * scale) at the largest scale of
    each pass, FXAA's search (6 steps over the 3x3-blurred image: 7 rows,
    fxaa.js:119-130) and TAA's 3x3 clamp (1). The halo pipeline is exact
    when every pass's reach fits its halo, and a one-hop exchange bounds
    the halo by the strip's rows."""
    from ..post.filters import STENCIL3, STENCIL3_NO_CENTER

    need = 0
    if config.filter:
        if config.first_passes > 0:
            need = max(need, _stencil_reach(STENCIL3, FIRST_BOUNDS[1]), 1)
        if config.second_passes > 0:
            need = max(need, _stencil_reach(STENCIL3_NO_CENTER, SECOND_BOUNDS[1]))
        need = max(need, _stencil_reach(STENCIL3, FINAL_BOUNDS[1]))
    if config.antialiasing == "fxaa":
        need = max(need, 7)
    elif config.antialiasing == "taa":
        need = max(need, 1)
    return need


def tileize_blur_key_sharded(ocolor_p: torch.Tensor, row0: int, height: int, mesh,
                             axis_name: str = "tile", ty: int = 32, tx: int = 128):
    """post.filter_kernel.tileize_blur_key_packed on this rank's strip of
    the packed originalColor plane, on the one-process (ty, tx) grid
    anchored at the image origin: each rank sums its rows into the global
    tile rows it overlaps, an all-reduce of the [ceil(H / ty), ceil(W /
    tx)] sums and counts (a few KB) completes the tiles that straddle a
    strip border, and each rank reads back its rows' means. A straddling
    tile's sum adds the strips' partial sums, another order than the one
    process's, so its quantized mean may differ by one step."""
    from ..post.filter_kernel import apply_blur_key_means, blur_key_tile_sums, byte_f

    sums, counts = blur_key_tile_sums(byte_f(ocolor_p, 3), ty, tx, row0)
    tr0 = row0 // ty
    grid = torch.zeros((2, -(-height // ty), sums.shape[1]), dtype=torch.float32,
                       device=ocolor_p.device)
    grid[0, tr0:tr0 + sums.shape[0]] = sums
    grid[1, tr0:tr0 + sums.shape[0]] = counts
    grid = all_reduce(grid, dist.ReduceOp.SUM, mesh, axis_name)[:, tr0:tr0 + sums.shape[0]]
    return apply_blur_key_means(ocolor_p, grid[0], grid[1], ty, tx, row0)


def _shards(height: int, n_tile: int) -> int:
    if height % n_tile != 0:
        raise ValueError(f"height {height} not divisible by the tile axis {n_tile}")
    return height // n_tile


def render_mrt_sharded(buffers, width: int, height: int, camera_pos, view_matrix, config,
                       random_seed, mesh, scheme: str = "kernel", kernels=None,
                       tile: int = 1024) -> MRT:
    """The whole frame's MRT with rows sharded over "tile" and the sample
    loop over "sample"; every rank returns the whole flat [H * W] MRT on
    its render device.

    The cross-sample combine follows the reference's sequential sample
    loop over its shader globals (glsl:84-89, 555-576): renderId.xyz,
    glassFilter, originalRMEx and the color sum over the samples;
    originalColor, originalTPOx, renderId.w (and the sample-independent
    coverage and location) are the last sample's; firstRayLength is a
    running min; original_w = min(rme_total, frl_min) + 1/255 (glsl:635)."""
    _, ti, n_tile = mesh_axis(mesh, "tile")
    _, si, n_sample = mesh_axis(mesh, "sample")
    rows_local = _shards(height, n_tile)
    if config.samples_per_ray % n_sample != 0:
        raise ValueError(f"samples_per_ray {config.samples_per_ray} not divisible by the "
                         f"sample axis {n_sample}")
    samples_local = config.samples_per_ray // n_sample
    mrt, (rme_x, frl) = render_mrt(
        buffers, width, height, camera_pos, view_matrix, config, random_seed, scheme=scheme,
        kernels=kernels, tile=tile, row0=ti * rows_local, rows=rows_local,
        sample_offset=si * samples_local, local_samples=samples_local, with_raw_aux=True)

    def sum_s(x):
        return all_reduce(x, dist.ReduceOp.SUM, mesh, "sample")

    def last_s(x):
        return broadcast(x, n_sample - 1, mesh, "sample")

    cov = mrt.alpha > 0.0
    frl_min = all_reduce(frl, dist.ReduceOp.MIN, mesh, "sample")
    original_w = torch.where(cov, torch.minimum(sum_s(rme_x), frl_min) + INV_255, 0.0)
    render_id = torch.cat([sum_s(mrt.render_id[:, 0:3]), last_s(mrt.render_id[:, 3:4])],
                          dim=-1)
    out = MRT(color=sum_s(mrt.color), glass=sum_s(mrt.glass),
              original_color=last_s(mrt.original_color), original_w=original_w,
              render_id=render_id, original_id_w=last_s(mrt.original_id_w),
              location_id=last_s(mrt.location_id), alpha=last_s(mrt.alpha))
    return MRT(*(all_gather(x, mesh, "tile") for x in out))


def frame_pipeline_sharded(buffers, cam_pos, view, random_seed, temporal_state, taa_state,
                           width: int, height: int, config, mesh, scheme: str = "kernel",
                           kernels=KERNELS, tile: int = 1024):
    """A whole frame: the sharded MRT pass, then the one-process post on
    every rank (models.pathtracer.frame_pipeline with the MRT distributed).
    Returns (display, temporal state, TAA state)."""
    mrt = render_mrt_sharded(buffers, width, height, cam_pos, view, config, random_seed, mesh,
                             scheme=scheme, kernels=kernels, tile=tile)
    return postprocess_mrt(mrt, temporal_state, taa_state, width, height, config, kernels)


def frame_pipeline_sharded_halo(buffers, cam_pos, view, random_seed, temporal_state,
                                taa_state, width: int, height: int, config, mesh,
                                scheme: str = "kernel", kernels=KERNELS, tile: int = 1024,
                                halo: int = 32, check_halo: bool = True):
    """A whole frame with the path trace AND the post-processing strip-
    sharded: the one post chain (post.chain.postprocess_mrt) on each
    rank's strip, its temporal accumulation pointwise; the denoise passes
    and FXAA take `halo` border rows from the neighbours around each pass
    (parallel.halo), TAA's clamp a 1-row halo; only the display strips
    and the updated history strips are gathered. Identical to the
    one-process pipeline wherever each pass's reach fits the halo, but
    for the blur key of a tile that straddles a strip border
    (`tileize_blur_key_sharded`). Uses the "tile" axis only.

    Exactness guard: the config's worst-case reach
    (`required_post_halo`) must fit the strip, since one exchange reaches
    only the adjacent strip; otherwise the frame takes the all-gather post
    of `frame_pipeline_sharded`, the reference's own semantics for that
    case (not a device fallback). check_halo=False keeps the halo path for
    callers that know their scene's data reach fits `halo`."""
    _, ti, n_tile = mesh_axis(mesh, "tile")
    rows_local = _shards(height, n_tile)
    if check_halo:
        need = required_post_halo(config)
        if need > rows_local:
            return frame_pipeline_sharded(buffers, cam_pos, view, random_seed, temporal_state,
                                          taa_state, width, height, config, mesh,
                                          scheme=scheme, kernels=kernels, tile=tile)
        halo = max(halo, need)
    halo = min(halo, rows_local)
    row0 = ti * rows_local
    rows = slice(row0, row0 + rows_local)

    def taa_step(state, aa_in):
        # the 3x3 clamp is TAA's only cross-pixel read: a 1-row halo; the
        # history strips stay local until the gather
        mn, mx = neighborhood_clamp(exchange_halo(aa_in, 1, mesh))
        out, mine = taa_apply(TAAState(history=state.history[:, rows]), aa_in,
                              clamp=(mn[1:-1], mx[1:-1]))
        return out, TAAState(history=all_gather(mine.history, mesh, "tile", dim=1))

    mrt = render_mrt(buffers, width, height, cam_pos, view, config, random_seed,
                     scheme=scheme, kernels=kernels, tile=tile, row0=row0, rows=rows_local)
    my_state = TemporalState(*(x[:, rows] for x in temporal_state))
    display, my_state, new_taa = postprocess_mrt(
        mrt, my_state, taa_state, width, rows_local, config, kernels,
        lift=lambda f: with_halo(f, halo, mesh),
        tileize=partial(tileize_blur_key_sharded, row0=row0, height=height, mesh=mesh),
        taa_step=taa_step)
    display = all_gather(display, mesh, "tile")
    new_state = TemporalState(*(all_gather(x, mesh, "tile", dim=1) for x in my_state))
    return display, new_state, new_taa
