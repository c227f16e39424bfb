"""Clustered two-phase traversal: the reference's scheme="clustered"
(flexlight_tpu/ops/traverse_clustered.py), its CPU route above 8192
triangles, in plain float32 PyTorch.

1. The triangles are cut into K clusters of C consecutive drawables
   (flattened BVH order, spatially coherent) with per-cluster MT rows
   (ops.traverse_mxu `build_tri_matrix`) and boxes (`build_clusters`).
2. Phase A: a stable sort by direction octant groups the rays; every ray
   of a group of `group` blocks of `block` rays slab-tests every cluster
   box, and the group takes the union of its rays' hits, ordered hit
   first, nearest entry first (a stable argsort, so equal keys keep the
   cluster order).
3. Phase B: the group scans its ordered clusters in chunks of `k_cand`;
   a chunk that holds a hit cluster is evaluated for every ray of the
   group (the MT products of ops.traverse_mxu, then the accept window),
   a chunk without one is skipped, and the chunks' bests merge in chunk
   order (a later chunk wins only when strictly nearer).

flexlight_tpu maps phase B over the groups with a per-chunk `lax.cond`.
Here every group's union and cluster order come from slices of groups on
the device, the host reads the groups' live-chunk counts once per cast
(the hit clusters sort first, so a group's live chunks are the first
ceil(hits / k_cand)), and for each chunk index the groups whose chunk is
live are evaluated together in batched products, each group on its own
clusters, then merged: the same evaluations, merged in the same order, as
the per-group loop. A pair's products are `record_products` of
ops.intersect_sparse_kernel on the triangle's 16-float record (read off
W): the 25 non-zero terms of W's 64 in W's k order, so the values of
ops.intersect.mt_products but for a zero's sign, which no accept
decision reads, at 2.5x fewer operations.

Ties go where the reference sends them: the first minimum within a chunk
(over its clusters in sorted order, then their triangles), the earlier
chunk across chunks. Padded ray slots (origin 0, direction (1, 1, 1),
max_len 0) take part in their group's union as in the reference, and a
chunk's slots past K re-evaluate cluster 0, which changes no result."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .intersect import BIAS, POW32
from .intersect_sparse_kernel import record_products
from .traverse import Hit
from .traverse_mxu import build_tri_matrix

CLUSTER_BATCH_VALUES = 1 << 26   # float32 values of one [groups, rays, pairs] tensor


class Clusters(NamedTuple):
    w: torch.Tensor          # [K, 16, 4C] per-cluster MT rows
    aabb_min: torch.Tensor   # [K, 3]
    aabb_max: torch.Tensor   # [K, 3]
    tri_slots: torch.Tensor  # [K, C] int32 geometry slot per padded triangle (-1 pad)


def build_clusters(world_geom: torch.Tensor, id_buffer: torch.Tensor,
                   cluster_size: int = 64) -> Clusters:
    t = id_buffer.shape[0]
    c = cluster_size
    k = -(-t // c)
    pad = k * c - t
    w = F.pad(build_tri_matrix(world_geom, id_buffer), (0, pad * 4))  # [16, 4KC]
    w = w.reshape(16, k, c * 4).permute(1, 0, 2).contiguous()          # [K, 16, 4C]
    verts = world_geom[id_buffer.long()][:, 0:9].reshape(t, 3, 3)
    vmin = F.pad(verts.amin(dim=1), (0, 0, 0, pad), value=float("inf"))
    vmax = F.pad(verts.amax(dim=1), (0, 0, 0, pad), value=float("-inf"))
    tri_slots = F.pad(id_buffer.to(torch.int32), (0, pad), value=-1).reshape(k, c)
    return Clusters(w=w, aabb_min=vmin.reshape(k, c, 3).amin(dim=1),
                    aabb_max=vmax.reshape(k, c, 3).amax(dim=1), tri_slots=tri_slots)


def _cluster_hits(clusters: Clusters, origin, direction, max_len):
    """Slab test of rays [..., 3] against every cluster box: (hit, tmin),
    each [..., K]; `max_len` broadcasts against [..., K]. NaN (0 * inf at
    a zero direction component) propagates as jnp.minimum / jnp.max
    propagate it: torch.minimum / maximum, never fmin."""
    inv_d = 1.0 / direction
    tmin = tmax = None
    for a in range(3):
        t0 = (clusters.aabb_min[:, a] - origin[..., a, None]) * inv_d[..., a, None]
        t1 = (clusters.aabb_max[:, a] - origin[..., a, None]) * inv_d[..., a, None]
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tmin = lo if tmin is None else torch.maximum(tmin, lo)
        tmax = hi if tmax is None else torch.minimum(tmax, hi)
    hit = (tmax >= torch.clamp_min(tmin, BIAS)) & (tmin < max_len)
    return hit, tmin


def _mt_epilogue(prod, cull: bool, max_len, edge: float = BIAS):
    """prod = (det, udet, vdet, sdet) -> (s, u, v, valid) with the glsl
    accept window; edge = -BIAS on primary casts."""
    det, udet, vdet, sdet = prod
    inv = 1.0 / det
    u = udet * inv
    v = vdet * inv
    s = sdet * inv
    valid = (det >= BIAS) if cull else (torch.abs(det) >= BIAS)
    valid &= (u >= edge) & (u <= 1.0)
    valid &= (v >= edge) & (u + v <= 1.0)
    valid &= (s > BIAS) & (s <= max_len)
    return s, u, v, valid


class _Best(NamedTuple):
    s: torch.Tensor    # best distance (POW32 = miss)
    u: torch.Tensor
    v: torch.Tensor
    tri: torch.Tensor  # geometry slot, -1 = miss


def _best_none(shape, device) -> _Best:
    return _Best(s=torch.full(shape, POW32, dtype=torch.float32, device=device),
                 u=torch.zeros(shape, dtype=torch.float32, device=device),
                 v=torch.zeros(shape, dtype=torch.float32, device=device),
                 tri=torch.full(shape, -1, dtype=torch.int32, device=device))


def _best_merge(a: _Best, b: _Best) -> _Best:
    take_b = b.s < a.s
    return _Best(*(torch.where(take_b, y, x) for x, y in zip(a, b)))


def _best_of(s, u, v, valid, tri_slots) -> _Best:
    """Reduce [..., M, C] pairs (s, u, v, valid; tri_slots [.., M, C]
    without the ray axis) to each ray's best hit: the first minimum over
    (M, C) in order."""
    lead = s.shape[:-2]
    s_masked = torch.where(valid, s, torch.full_like(s, POW32)).reshape(*lead, -1)
    best = s_masked.argmin(dim=-1, keepdim=True)

    def take(x):
        return torch.gather(x.reshape(*lead, -1), -1, best)[..., 0]

    best_s = take(s_masked)
    tri = tri_slots.reshape(*tri_slots.shape[:-2], 1, -1).expand(*lead, -1)
    miss = best_s >= POW32
    return _Best(s=best_s, u=torch.where(miss, 0.0, take(u)), v=torch.where(miss, 0.0, take(v)),
                 tri=torch.where(miss, -1, torch.gather(tri, -1, best)[..., 0]))


def _records(w: torch.Tensor) -> torch.Tensor:
    """Cluster W [K, 16, 4C] -> [K, C, 16] triangle records (the layout of
    ops.intersect_sparse.tri_record): each W entry or its exact negation."""
    k, _, c4 = w.shape
    p = w.reshape(k, 16, c4 // 4, 4)
    u, v, s = p[..., 1], p[..., 2], p[..., 3]
    return torch.stack([s[:, 1], s[:, 2], s[:, 3], -s[:, 0], -u[:, 4], -u[:, 5], -u[:, 6],
                        -v[:, 4], -v[:, 5], -v[:, 6], u[:, 14], u[:, 9], u[:, 10], v[:, 12],
                        v[:, 13], v[:, 8]], dim=-1)


def _pad_rows(x, pad: int, fill: float):
    return F.pad(x, (0, 0) * (x.ndim - 1) + (0, pad), value=fill)


def _traverse_impl(clusters: Clusters, origin, direction, max_len, block: int = 1024,
                   k_cand: int = 64, group: int = 2, shadow: bool = False,
                   sort_rays: bool = True, edge: float = BIAS):
    n = origin.shape[0]
    dev = origin.device
    if sort_rays:
        # a stable sort by direction octant: rays of like direction share
        # groups, the pixel order kept within an octant
        key = ((direction[:, 0] > 0).to(torch.int32) * 4
               + (direction[:, 1] > 0).to(torch.int32) * 2
               + (direction[:, 2] > 0).to(torch.int32))
        perm = torch.argsort(key, stable=True)
        inv_perm = torch.argsort(perm, stable=True)
        origin, direction, max_len = origin[perm], direction[perm], max_len[perm]
    k, _, c4 = clusters.w.shape
    c = c4 // 4
    k_cand = min(k_cand, k)
    nb = -(-n // block)
    ng = -(-nb // group)
    r = group * block
    pad = ng * r - n     # the block padding and the group padding alike
    plus_z = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=dev)
    safe_dir = torch.where(((direction * direction).sum(dim=-1) > 0.0)[:, None], direction,
                           plus_z)
    o_g = _pad_rows(origin, pad, 0.0).reshape(ng, r, 3)
    d_g = _pad_rows(safe_dir, pad, 1.0).reshape(ng, r, 3)
    ml_g = _pad_rows(max_len, pad, 0.0).reshape(ng, r)

    # phase A: each group's hit union and cluster order, in slices of groups
    nchunks = -(-k // k_cand)
    orders, n_hit = [], []
    step = max(1, CLUSTER_BATCH_VALUES // (r * k))
    for g0 in range(0, ng, step):
        hit, tmin = _cluster_hits(clusters, o_g[g0:g0 + step], d_g[g0:g0 + step],
                                  ml_g[g0:g0 + step, :, None])
        any_hit = hit.any(dim=1)
        entry = torch.where(hit, tmin, POW32).amin(dim=1)
        orders.append(torch.argsort(torch.where(any_hit, entry, POW32), dim=-1, stable=True))
        n_hit.append(any_hit.sum(dim=-1))
    # slots past K take cluster 0: they run only beside a real hit, and
    # evaluating a cluster twice changes neither a closest nor an any hit
    order = F.pad(torch.cat(orders), (0, nchunks * k_cand - k))
    live = (-(-torch.cat(n_hit) // k_cand)).tolist()   # the host's one read of the cast

    # phase B: chunk by chunk, the groups whose chunk is live, batched
    rec = _records(clusters.w)
    best = _best_none((ng, r), dev)
    batch = max(1, CLUSTER_BATCH_VALUES // (r * k_cand * c))
    for j in range(max(live, default=0)):
        groups = [g for g, m in enumerate(live) if m > j]
        for b0 in range(0, len(groups), batch):
            gi = torch.tensor(groups[b0:b0 + batch], device=dev)
            sel = order[gi, j * k_cand:(j + 1) * k_cand]              # [B, M]
            b = sel.shape[0]
            q = rec[sel].reshape(b, 1, k_cand * c, 16)
            tri_sel = clusters.tri_slots[sel]                          # [B, M, C]
            o, d = o_g[gi], d_g[gi]
            prod = record_products([q[..., i] for i in range(16)],
                                   [o[..., a, None] for a in range(3)],
                                   [d[..., a, None] for a in range(3)])
            s, u, v, valid = _mt_epilogue(prod, shadow, ml_g[gi][..., None], edge=edge)
            valid &= (tri_sel >= 0).reshape(b, 1, -1)
            shape = (b, r, k_cand, c)
            new = _best_of(s.reshape(shape), u.reshape(shape), v.reshape(shape),
                           valid.reshape(shape), tri_sel)
            merged = _best_merge(_Best(*(x[gi] for x in best)), new)
            for x, y in zip(best, merged):
                x[gi] = y

    flat = _Best(*(x.reshape(-1)[:n] for x in best))
    if sort_rays:
        flat = _Best(*(x[inv_perm] for x in flat))
    if shadow:
        return flat.tri >= 0
    suv = torch.where((flat.tri >= 0)[:, None], torch.stack([flat.s, flat.u, flat.v], dim=-1),
                      0.0)
    return Hit(suv=suv, triangle=flat.tri)


def traverse_clustered(clusters: Clusters, origin, direction, block: int = 1024,
                       k_cand: int = 64, group: int = 2, edge: float = BIAS) -> Hit:
    """Closest hit of rays [N, 3]: Hit(suv [N, 3], triangle [N] int32 slot)."""
    max_len = torch.full(origin.shape[:1], POW32, dtype=torch.float32, device=origin.device)
    return _traverse_impl(clusters, origin, direction, max_len, block=block, k_cand=k_cand,
                          group=group, shadow=False, edge=edge)


def shadow_clustered(clusters: Clusters, origin, direction, max_len, block: int = 1024,
                     k_cand: int = 64, group: int = 2) -> torch.Tensor:
    """Any hit within max_len [N] (front faces only): bool [N]."""
    return _traverse_impl(clusters, origin, direction, max_len, block=block, k_cand=k_cand,
                          group=group, shadow=True)
