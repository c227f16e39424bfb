"""Kernels 6-9 of the port (csrc/sparse.cu): the tile flags, the nearest2
sort key, and closest hit / any hit over each ray tile's worklist of
128-triangle tiles, behind their plain PyTorch versions.

The plain versions compute the same functions as the kernels without
their scheduling:
- `flags_plain` is flexlight_tpu's `_tmins_xla`: per (ray tile, triangle
  tile) the least slab-entry distance of a live ray into one of the tile's
  two 64-triangle cluster boxes, POW32 where no ray enters one;
- `nearest2_key_plain` is its `_nearest2_key_xla` on the supertile boxes;
- `closest_plain` / `any_plain` evaluate every tile of a ray tile's
  worklist for every ray of the tile, in ascending tile order, so
  `argmin`'s first minimum is the lowest drawable index. They read the
  triangle records of ops.intersect_sparse (`rec`, [WT, 128, 16]) and form
  the four Moeller-Trumbore products from their non-zero terms only
  (`record_products`): the terms of ops.intersect_kernel's 16 rank-1
  updates in k order, with their signs as exact negations. Where a partial
  sum is non-zero, adding an exact zero product leaves it unchanged, so
  the products equal ops.intersect.mt_products' (a zero may differ in
  sign).
The kernels walk the worklist in entry order instead, each warp on its
own: a ray is done once its best hit cannot reach the next tile's entry
bound (flexlight_tpu's guard band, `_EXIT_REL` / `_EXIT_ABS`), or once it
is occluded (any hit). The closest hit keeps the lexicographic minimum
(s, drawable index), so both sides pick the same triangle. Before the
division the kernels reject pairs only where the accept window rejects
them too (csrc/sparse.cu), so every accepted pair has the plain version's
s, u and v.

Rays come as SoA channels padded to whole ray tiles, directions already
through `intersect_sparse._prep_soa`. Triangle indices are drawable
indices (positions in id_buffer order)."""

from __future__ import annotations

import torch

from .. import _native
from .intersect import BIAS, POW32
from .intersect_kernel import ray_args
from .intersect_sparse import CLUSTER, REC, TRI_TILE

CLUSTERS_PER_TILE = TRI_TILE // CLUSTER
TINY_DIR = 1e-30         # a zero direction component in the slab test
MAX_RAY_TILE = 1024      # threads of a block
FLAGS_RAY_TILE = 128     # rays of a ray tile of the flags (csrc/sparse.cu FL_FLAGS_RAY_TILE):
                         # one warp holds them, 4 a lane
CAST_LANES = 8           # threads per ray of the casts (csrc/sparse.cu FL_SUB_LANES), whose
                         # block is one ray tile: at most 1024 threads
DEAD_KEY = 1 << 30
# the closest-hit kernel's exit guard band (csrc/sparse.cu FL_EXIT_REL /
# FL_EXIT_ABS, flexlight_tpu/ops/intersect_sparse.py:602-603): it leaves the
# worklist once best * EXIT_REL + EXIT_ABS < the next tile's entry bound
# for every live ray of the tile
EXIT_REL, EXIT_ABS = 1.0 + 1e-4, 1e-5
_BUDGET = 1 << 25        # float elements per chunk of the plain versions


def _stack3(o3, d3):
    return torch.stack(o3, dim=-1), torch.stack(d3, dim=-1)


def _slab(lo, hi, o, inv):
    """(tmin, tmax) of rays [m, 3] against boxes [K, 3]: [m, K] each,
    NaN-propagating like the kernel's fl_minimum / fl_maximum."""
    t0 = (lo[None] - o[:, None]) * inv[:, None]
    t1 = (hi[None] - o[:, None]) * inv[:, None]
    return torch.minimum(t0, t1).amax(dim=-1), torch.maximum(t0, t1).amin(dim=-1)


def _inv_dir(d):
    return 1.0 / torch.where(d == 0.0, TINY_DIR, d)


def cluster_minima_plain(amin, amax, o3, d3, max_len, ray_tile: int):
    """[RT, K] f32: the least entry distance of a live ray of each ray tile
    into each cluster box (POW32: none enters it), the flags before each
    triangle tile's minimum over its clusters."""
    n = max_len.shape[0]
    k = amin.shape[0]
    o, d = _stack3(o3, d3)
    step = max(1, _BUDGET // (8 * k * ray_tile)) * ray_tile
    per = []
    for a in range(0, n, step):
        b = min(a + step, n)
        tmin, tmax = _slab(amin, amax, o[a:b], _inv_dir(d[a:b]))
        entry = torch.maximum(tmin, tmin.new_tensor(BIAS))
        ml = max_len[a:b, None]
        hit = (tmax >= entry) & (tmin < ml) & (ml > 0.0)
        e = torch.where(hit, entry, POW32)
        per.append(e.reshape(-1, ray_tile, k).amin(dim=1))
    return torch.cat(per)


def flags_plain(amin, amax, o3, d3, max_len, ray_tile: int):
    """[RT, WT] f32: the least entry distance of a live ray of each ray
    tile into each triangle tile (POW32: none enters it)."""
    rt, wt = max_len.shape[0] // ray_tile, amin.shape[0] // CLUSTERS_PER_TILE
    minima = cluster_minima_plain(amin, amax, o3, d3, max_len, ray_tile)
    return minima.reshape(rt, wt, CLUSTERS_PER_TILE).amin(dim=-1)


def nearest2_key_plain(bmin, bmax, o3, d3, max_len):
    """int32 [N] wavefront sort key: (nearest supertile box, second
    nearest, direction octant) packed as (i1 * (nb + 1) + i2) * 8 + octant;
    nb where there is no such box, DEAD_KEY for dead rays."""
    nb = bmin.shape[0]
    n = max_len.shape[0]
    o, d = _stack3(o3, d3)
    iota = torch.arange(nb, dtype=torch.int32, device=o.device)
    step = max(1, _BUDGET // (8 * nb))
    keys = []
    for a in range(0, n, step):
        b = min(a + step, n)
        dd, ml = d[a:b], max_len[a:b]
        tmin, tmax = _slab(bmin, bmax, o[a:b], _inv_dir(dd))
        entry = torch.maximum(tmin, tmin.new_tensor(BIAS))
        e = torch.where((tmax >= entry) & (tmin < ml[:, None]), entry, POW32)
        e1 = e.amin(dim=1, keepdim=True)
        j1 = torch.where(e <= e1, iota, nb + 1).amin(dim=1)
        emask = torch.where(iota == j1[:, None], POW32, e)
        e2 = emask.amin(dim=1, keepdim=True)
        j2 = torch.where(emask <= e2, iota, nb + 1).amin(dim=1)
        j1 = torch.where(e1[:, 0] >= POW32, nb, j1)
        j2 = torch.where(e2[:, 0] >= POW32, nb, j2)
        # d >= 0 is the kernel's 1/d > 0 (a zero component maps to +1e-30)
        octant = ((dd[:, 0] >= 0.0).to(torch.int32) * 4 + (dd[:, 1] >= 0.0).to(torch.int32) * 2
                  + (dd[:, 2] >= 0.0).to(torch.int32))
        key = (j1 * (nb + 1) + j2) * 8 + octant
        keys.append(torch.where(ml <= 0.0, DEAD_KEY, key).to(torch.int32))
    return torch.cat(keys)


def record_products(q, o, d):
    """(det, udet, vdet, sdet) from the 16 record columns `q` and the ray's
    origin and direction components `o`, `d` (3 each), all broadcast
    together: the non-zero terms of ops.intersect.tri_rows in
    ascending k, each negated term an exact negation or subtraction, in
    the kernel's order (csrc/sparse.cu fl_rec_*)."""
    n0, n1, n2, v0n, c0, c1, c2, g0, g1, g2, e2x, e2y, e2z, e1x, e1y, e1z = q
    # vec(d (x) o) at k = 8, 9, 10, 12, 13, 14 (k = 7, 11, 15 meet zeros)
    f8, f9, f10 = d[0] * o[1], d[0] * o[2], d[1] * o[0]
    f12, f13, f14 = d[1] * o[2], d[2] * o[0], d[2] * o[1]
    det = -((n0 * d[0] + n1 * d[1]) + n2 * d[2])
    sdet = ((n0 * o[0] - v0n) + n1 * o[1]) + n2 * o[2]
    udet = (-((c0 * d[0] + c1 * d[1]) + c2 * d[2]) - e2z * f8 + e2y * f9 + e2z * f10
            - e2x * f12 - e2y * f13 + e2x * f14)
    vdet = (-((g0 * d[0] + g1 * d[1]) + g2 * d[2]) + e1z * f8 - e1y * f9 - e1z * f10
            + e1x * f12 + e1y * f13 - e1x * f14)
    return det, udet, vdet, sdet


def _worklist_products(rec, tlist, counts, o3, d3, ray_tile: int):
    """Per chunk of ray tiles: (first ray, candidate tiles [G, C] in
    ascending order padded with an all-zero tile, det, udet, vdet, sdet
    each [G, R, C * TRI_TILE]), the products of every ray of a ray tile
    with every triangle of its worklist."""
    wt = rec.shape[0]
    rt = counts.shape[0]
    dev = rec.device
    # [WT + 1, TRI_TILE, 16]: the tiles, plus a zero tile (det = 0 rejects it)
    tiles = torch.cat([rec, torch.zeros((1, TRI_TILE, REC), dtype=rec.dtype, device=dev)])
    slot = torch.arange(tlist.shape[1], device=dev)
    cand_all = torch.where(slot[None] < counts[:, None].long(), tlist.long(), wt)
    cand_all = cand_all.sort(dim=1).values
    o = [c.reshape(rt, ray_tile, 1) for c in o3]
    d = [c.reshape(rt, ray_tile, 1) for c in d3]
    per_tile = [int(c) for c in counts.tolist()]
    g0 = 0
    while g0 < rt:
        # as many ray tiles as fit the budget at their longest worklist
        g1, cmax = g0 + 1, max(per_tile[g0], 1)
        while g1 < rt:
            c = max(cmax, per_tile[g1])
            if (g1 + 1 - g0) * ray_tile * c * TRI_TILE * 4 > _BUDGET:
                break
            g1, cmax = g1 + 1, c
        cand = cand_all[g0:g1, :cmax]
        wk = tiles[cand].reshape(g1 - g0, 1, cmax * TRI_TILE, REC)     # [G, 1, M, 16]
        q = [wk[..., k] for k in range(REC)]
        prod = record_products(q, [c[g0:g1] for c in o], [c[g0:g1] for c in d])
        yield (g0, cand) + prod
        g0 = g1


def closest_plain(rec, tlist, tms, counts, o3, d3, max_len, edge: float, ray_tile: int):
    """Closest hit of each ray over its ray tile's worklist (`tlist[rt,
    :counts[rt]]`; `tms`, the entry bounds, only order the kernel's walk).
    Returns (s, u, v, tri): [N] f32 (0 on a miss) and drawable index [N]
    int32 (-1 on a miss); ties in s go to the lowest drawable index."""
    n = max_len.shape[0]
    s_out = torch.zeros(n, dtype=torch.float32, device=max_len.device)
    u_out, v_out = torch.zeros_like(s_out), torch.zeros_like(s_out)
    tri_out = torch.full((n,), -1, dtype=torch.int32, device=max_len.device)
    for g0, cand, det, udet, vdet, sdet in _worklist_products(rec, tlist, counts, o3, d3,
                                                               ray_tile):
        g = cand.shape[0]
        a, b = g0 * ray_tile, (g0 + g) * ray_tile
        ml = max_len[a:b].reshape(g, ray_tile, 1)
        inv = 1.0 / det
        u = udet * inv
        v = vdet * inv
        s = sdet * inv
        valid = torch.abs(det) >= BIAS
        valid &= (u >= edge) & (u <= 1.0)
        valid &= (v >= edge) & (u + v <= 1.0)
        valid &= (s > BIAS) & (s <= ml)
        s_masked = torch.where(valid, s, POW32)
        best = torch.argmin(s_masked, dim=-1, keepdim=True)   # first minimum on ties

        def pick(x):
            return torch.gather(x, 2, best)[..., 0].reshape(-1)

        hit = pick(s_masked) < POW32
        tile = torch.gather(cand, 1, (best[..., 0] // TRI_TILE)).reshape(-1)
        tri = (tile * TRI_TILE + (best[..., 0] % TRI_TILE).reshape(-1)).to(torch.int32)
        s_out[a:b] = torch.where(hit, pick(s), 0.0)
        u_out[a:b] = torch.where(hit, pick(u), 0.0)
        v_out[a:b] = torch.where(hit, pick(v), 0.0)
        tri_out[a:b] = torch.where(hit, tri, -1)
    return s_out, u_out, v_out, tri_out


def any_plain(rec, tlist, counts, o3, d3, max_len, ray_tile: int):
    """Front-face-culled any hit within max_len over the worklists
    (glsl:143-158). Returns bool [N]."""
    n = max_len.shape[0]
    out = torch.zeros(n, dtype=torch.bool, device=max_len.device)
    for g0, cand, det, udet, vdet, sdet in _worklist_products(rec, tlist, counts, o3, d3,
                                                               ray_tile):
        g = cand.shape[0]
        a, b = g0 * ray_tile, (g0 + g) * ray_tile
        ml = max_len[a:b].reshape(g, ray_tile, 1)
        inv = 1.0 / det
        u = udet * inv
        v = vdet * inv
        s = sdet * inv
        valid = det >= BIAS
        valid &= (u >= BIAS) & (u <= 1.0)
        valid &= (v >= BIAS) & (u + v <= 1.0)
        valid &= (s > BIAS) & (s <= ml)
        out[a:b] = valid.any(dim=-1).reshape(-1)
    return out


def _tiles_of(n: int, ray_tile: int, most: int = MAX_RAY_TILE) -> int:
    if not 0 < ray_tile <= most or n % ray_tile:
        raise ValueError(f"{n} rays do not make whole ray tiles of {ray_tile} "
                         f"(at most {most})")
    return n // ray_tile


def _boxes(lo, hi, name, dev):
    k = lo.shape[0]
    _native.require(lo, f"{name}_min", torch.float32, (k, 3), dev)
    _native.require(hi, f"{name}_max", torch.float32, (k, 3), dev)
    return k


def _worklist_args(rec, tlist, counts, rt, dev):
    wt = rec.shape[0]
    _native.require(rec, "rec", torch.float32, (wt, TRI_TILE, REC), dev)
    if _native.ptr(rec) % 16:
        raise ValueError("rec: the kernels copy it in 16-byte pieces; it must be 16-byte aligned")
    _native.require(tlist, "tlist", torch.int32, (rt, wt), dev)
    _native.require(counts, "counts", torch.int32, (rt,), dev)
    return wt


def _flags_launch(lib, stream, amin, amax, o3, d3, max_len, ray_tile: int):
    dev = max_len.device
    k = _boxes(amin, amax, "aabb", dev)
    if k % CLUSTERS_PER_TILE:
        raise ValueError(f"{k} cluster boxes are not whole triangle tiles")
    n, ray_ptrs = ray_args(o3, d3, max_len, dev)
    rt, wt = _tiles_of(n, ray_tile, FLAGS_RAY_TILE), k // CLUSTERS_PER_TILE
    out = torch.empty((rt, wt), dtype=torch.float32, device=dev)
    _native.check(lib.fl_sparse_flags(_native.ptr(amin), _native.ptr(amax), wt, *ray_ptrs,
                                      ray_tile, rt, _native.ptr(out), stream), "sparse_flags")
    return out


def _key_launch(lib, stream, bmin, bmax, o3, d3, max_len):
    dev = max_len.device
    nb = _boxes(bmin, bmax, "box", dev)
    n, ray_ptrs = ray_args(o3, d3, max_len, dev)
    key = torch.empty(n, dtype=torch.int32, device=dev)
    _native.check(lib.fl_sparse_key(_native.ptr(bmin), _native.ptr(bmax), nb, *ray_ptrs, n,
                                    _native.ptr(key), stream), "sparse_key")
    return key


def _closest_launch(lib, stream, rec, tlist, tms, counts, o3, d3, max_len, edge: float,
                    ray_tile: int):
    dev = max_len.device
    n, ray_ptrs = ray_args(o3, d3, max_len, dev)
    rt = _tiles_of(n, ray_tile, MAX_RAY_TILE // CAST_LANES)
    wt = _worklist_args(rec, tlist, counts, rt, dev)
    _native.require(tms, "tms", torch.float32, (rt, wt), dev)
    s = torch.empty(n, dtype=torch.float32, device=dev)
    u, v = torch.empty_like(s), torch.empty_like(s)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    _native.check(lib.fl_sparse_closest(
        _native.ptr(rec), _native.ptr(tlist), _native.ptr(tms), _native.ptr(counts), wt,
        *ray_ptrs, float(edge), ray_tile, n, _native.ptr(s), _native.ptr(u), _native.ptr(v),
        _native.ptr(tri), stream), "sparse_closest")
    return s, u, v, tri


def _any_launch(lib, stream, rec, tlist, counts, o3, d3, max_len, ray_tile: int):
    dev = max_len.device
    n, ray_ptrs = ray_args(o3, d3, max_len, dev)
    rt = _tiles_of(n, ray_tile, MAX_RAY_TILE // CAST_LANES)
    wt = _worklist_args(rec, tlist, counts, rt, dev)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    _native.check(lib.fl_sparse_any(_native.ptr(rec), _native.ptr(tlist),
                                    _native.ptr(counts), wt, *ray_ptrs, ray_tile, n,
                                    _native.ptr(hit), stream), "sparse_any")
    return hit


sparse_flags = _native.Kernel("sparse_flags", flags_plain, _flags_launch)
sparse_key = _native.Kernel("sparse_key", nearest2_key_plain, _key_launch)
sparse_closest = _native.Kernel("sparse_closest", closest_plain, _closest_launch)
sparse_any = _native.Kernel("sparse_any", any_plain, _any_launch)
