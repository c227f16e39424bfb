"""Worklist-sparse closest hit and any hit for large scenes
(scheme="sparse", flexlight_tpu/ops/intersect_sparse.py): the plain tensor
code around kernels 6-9 (ops.intersect_sparse_kernel, csrc/sparse.cu).

The triangles are cut into 128-triangle tiles in drawable (id_buffer)
order, each with two 64-triangle cluster boxes. The casts read each
triangle as a 16-float record (`tri_record`, 64 B; a tile is 8 KB): the
16 distinct magnitudes of the four Moeller-Trumbore rows of
ops.intersect.tri_rows, which hold 25 non-zero terms of 64:

    [0:3]  n = e1 x e2      (det row: -n on d; sdet row: n on o)
    [3]    v0 . n           (sdet row: -v0.n on the constant 1)
    [4:7]  e2 x v0          (udet row: -(e2 x v0) on d)
    [7:10] v0 x e1          (vdet row: -(v0 x e1) on d)
    [10:13] e2              (udet row: skew(e2) on vec(d (x) o))
    [13:16] e1              (vdet row: -skew(e1) on vec(d (x) o))

with e1 = v1 - v0, e2 = v2 - v0; a padding triangle's record is all
zeros (det = 0 rejects it). One cast is:
1. for a hinted cast (a shadow or bounce ray of the bounce loop, on a
   scene of at least SORT_MIN_TILES tiles), the nearest2 sort key
   (`sparse_key`) and a stable sort of the wavefront by it, so that rays
   heading for the same geometry share ray tiles; primary casts stay in
   (block-tiled) pixel order;
2. the tile flags (`sparse_flags`): per ray tile of RAY_TILE rays, the
   least entry distance into each triangle tile;
3. the worklist of each ray tile (`_compact`): its flagged tiles in
   entry order;
4. closest hit (`sparse_closest`) or any hit (`sparse_any`) over the
   worklists, then the rays back in their order.
Results do not depend on the sort or on the ray tile (a tile's flag is the
union over its rays): tests/test_torch_sparse.py pins both.

The hit is the DRAWABLE index; callers gather their per-triangle tables
into drawable order once per frame. What stays behind from the TPU
version: bf16x6 limbs, the post-kernel (s, u, v) recovery (the kernel
writes exact values), the 1024-ray TPU tile and subtiles, and the
FLEXLIGHT_SPARSE_* / FLEXLIGHT_PAIR_CAST knobs (ROADMAP.md)."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .intersect import BIAS, POW32, cross

TRI_TILE = 128
CLUSTER = 64
SUPER_GROUP = 8          # cluster boxes per supertile box of the nearest2 key
RAY_TILE = 128
SORT_MIN_TILES = 8       # flexlight_tpu/ops/pathtrace.py:973
REC = 16                 # floats of a triangle record


class SparseScene(NamedTuple):
    """What the sparse casts of one frame read."""
    rec: torch.Tensor    # [WT, 128, 16] f32 triangle records in drawable order, zeros past T
    amin: torch.Tensor   # [WT * 2, 3] cluster boxes
    amax: torch.Tensor
    bmin: torch.Tensor   # [ceil(WT / 4), 3] supertile boxes
    bmax: torch.Tensor

    @property
    def n_tiles(self) -> int:
        return self.rec.shape[0]


def _super_boxes(amin, amax, group: int = SUPER_GROUP):
    """`group` consecutive cluster boxes as one supertile box."""
    k = amin.shape[0]
    pad = -k % group
    bmin = F.pad(amin, (0, 0, 0, pad), value=float("inf")).reshape(-1, group, 3).amin(dim=1)
    bmax = F.pad(amax, (0, 0, 0, pad), value=float("-inf")).reshape(-1, group, 3).amax(dim=1)
    return bmin.contiguous(), bmax.contiguous()


def tri_record(world_geom: torch.Tensor, id_buffer: torch.Tensor) -> torch.Tensor:
    """[T, 16] f32: each drawable triangle's record (module docstring),
    every value computed as ops.intersect.tri_rows computes it."""
    tris = world_geom[id_buffer.long()]
    v0, v1, v2 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    e1 = v1 - v0
    e2 = v2 - v0
    n = cross(e1, e2)
    v0n = v0[:, 0] * n[:, 0] + v0[:, 1] * n[:, 1] + v0[:, 2] * n[:, 2]
    return torch.cat([n, v0n[:, None], cross(e2, v0), cross(v0, e1), e2, e1], dim=-1)


def build_tiled(world_geom: torch.Tensor, id_buffer: torch.Tensor) -> SparseScene:
    """The triangle records in whole tiles, padded with zero records (det =
    0 rejects them), the cluster boxes (a padded triangle's box is empty:
    +inf min, -inf max) and the supertile boxes."""
    t = id_buffer.shape[0]
    tp = -(-t // TRI_TILE) * TRI_TILE
    rec = F.pad(tri_record(world_geom, id_buffer), (0, 0, 0, tp - t))
    verts = world_geom[id_buffer.long()][:, 0:9].reshape(t, 3, 3)
    vmin = F.pad(verts.amin(dim=1), (0, 0, 0, tp - t), value=float("inf"))
    vmax = F.pad(verts.amax(dim=1), (0, 0, 0, tp - t), value=float("-inf"))
    k = tp // CLUSTER
    amin = vmin.reshape(k, CLUSTER, 3).amin(dim=1).contiguous()
    amax = vmax.reshape(k, CLUSTER, 3).amax(dim=1).contiguous()
    return SparseScene(rec.reshape(tp // TRI_TILE, TRI_TILE, REC).contiguous(), amin, amax,
                       *_super_boxes(amin, amax))


def _prep_soa(o3, d3, max_len, ray_tile: int):
    """Zero directions become +z (flexlight_tpu/ops/intersect_kernel.py
    _prep_soa), and the rays are padded to whole ray tiles with dead rays.
    Returns contiguous (o3, d3, max_len) and the number of real rays."""
    n = max_len.shape[0]
    pad = -n % ray_tile
    dead = (d3[0] * d3[0] + d3[1] * d3[1] + d3[2] * d3[2]) <= 0.0
    d3 = (torch.where(dead, 0.0, d3[0]), torch.where(dead, 0.0, d3[1]),
          torch.where(dead, 1.0, d3[2]))
    o3 = tuple(F.pad(c, (0, pad)).contiguous() for c in o3)
    d3 = tuple(F.pad(c, (0, pad), value=1.0).contiguous() for c in d3)
    return o3, d3, F.pad(max_len, (0, pad)).contiguous(), n


def _compact(flags):
    """flags [RT, WT] -> (tlist [RT, WT] int32: the tiles in ascending entry
    distance, flagged ones first; tms [RT, WT] their entry bounds; counts
    [RT] int32: the flagged tiles per ray tile)."""
    tms, order = torch.sort(flags, dim=1, stable=True)
    counts = (flags < POW32).sum(dim=1).to(torch.int32)
    return order.to(torch.int32).contiguous(), tms.contiguous(), counts


def _carry_sort(key, cols):
    """Sort `cols` by `key` (stable). Returns (perm, sorted cols)."""
    perm = torch.sort(key, stable=True).indices
    return perm, tuple(c[perm] for c in cols)


def _carry_unsort(perm, cols):
    """The inverse of `_carry_sort`'s permutation, as a scatter."""
    out = []
    for c in cols:
        x = torch.empty_like(c)
        x[perm] = c
        out.append(x)
    return tuple(out)


def _default_kernels(kernels):
    if kernels is None:
        from . import intersect_sparse_kernel as kernels
    return kernels


def _sorted(scene: SparseScene, o3, d3, max_len, kernels):
    key = kernels.sparse_key(scene.bmin, scene.bmax, tuple(c.contiguous() for c in o3),
                             tuple(c.contiguous() for c in d3), max_len.contiguous())
    perm, cols = _carry_sort(key, (*o3, *d3, max_len))
    return perm, cols[0:3], cols[3:6], cols[6]


def _worklists(scene: SparseScene, o3, d3, max_len, ray_tile: int, kernels):
    o3, d3, ml, n = _prep_soa(o3, d3, max_len, ray_tile)
    flags = kernels.sparse_flags(scene.amin, scene.amax, o3, d3, ml, ray_tile)
    return (o3, d3, ml, n) + _compact(flags)


def traverse_sparse_soa(scene: SparseScene, o3, d3, alive=None, edge: float = BIAS,
                        sort_rays: bool = False, ray_tile: int = RAY_TILE, kernels=None):
    """Closest hit of the rays (SoA 3-tuples of [N]) over all triangles.
    `alive` (bool [N]) kills rays; `edge` is the accept window's u/v edge
    (-BIAS on primary casts). Returns (s, u, v, tri): [N] f32, 0 on a miss,
    and the drawable index [N] int32, -1 on a miss. `kernels` has
    sparse_key / sparse_flags / sparse_closest (default: the CUDA kernel
    wrappers of ops.intersect_sparse_kernel)."""
    kernels = _default_kernels(kernels)
    max_len = torch.full_like(o3[0], POW32)
    if alive is not None:
        max_len = torch.where(alive, max_len, 0.0)
    if sort_rays:
        perm, o3, d3, max_len = _sorted(scene, o3, d3, max_len, kernels)
    o3, d3, ml, n, tlist, tms, counts = _worklists(scene, o3, d3, max_len, ray_tile, kernels)
    s, u, v, tri = kernels.sparse_closest(scene.rec, tlist, tms, counts, o3, d3, ml, edge,
                                          ray_tile)
    s, u, v, tri = s[:n], u[:n], v[:n], tri[:n]
    if sort_rays:
        s, u, v, tri = _carry_unsort(perm, (s, u, v, tri))
    hit = tri >= 0
    return (torch.where(hit, s, 0.0), torch.where(hit, u, 0.0), torch.where(hit, v, 0.0),
            torch.where(hit, tri, -1))


def shadow_sparse_soa(scene: SparseScene, o3, d3, max_len, alive=None,
                      sort_rays: bool = False, ray_tile: int = RAY_TILE, kernels=None):
    """Front-face-culled any hit within max_len. Returns bool [N]."""
    kernels = _default_kernels(kernels)
    if alive is not None:
        max_len = torch.where(alive, max_len, 0.0)
    if sort_rays:
        perm, o3, d3, max_len = _sorted(scene, o3, d3, max_len, kernels)
    o3, d3, ml, n, tlist, _, counts = _worklists(scene, o3, d3, max_len, ray_tile, kernels)
    hit = kernels.sparse_any(scene.rec, tlist, counts, o3, d3, ml, ray_tile)[:n]
    if sort_rays:
        (hit,) = _carry_unsort(perm, (hit,))
    return hit
