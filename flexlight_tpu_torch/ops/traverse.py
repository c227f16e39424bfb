"""Traversal of the skip-pointer geometry list in plain PyTorch
(flexlight_tpu/ops/traverse.py): the reference's scheme="scan" and
scheme="packet" casts, which it writes in plain XLA, not in Pallas.

The flattened scene is a list of slots (triangles, kind 2; AABB nodes
with a skip count in column 6, kind 1; an end sentinel, kind 0), the
stackless encoding the reference's fragment shader walks
(pathtracer_fragment.glsl:172-280). Rays are [N, 3] float32 rows, world
geometry comes from ops.geometry.world_geometry.

- `traverse_scan` / `shadow_scan`: every ray tests every triangle, 16
  slots at a time; AABB nodes are ignored (a skipped subtree cannot hold
  the closest hit). Within a chunk the first of equal s wins (argmin),
  across chunks the later one. The reference also scans the chunks after
  the end sentinel, which change nothing; these stop at the last chunk
  that holds a triangle.
- `traverse_coherent` / `shadow_coherent`: tiles of `tile` rays walk the
  list with one cursor each and skip an AABB subtree when no ray of the
  tile enters its box; a triangle of equal s replaces the earlier one.
  The tiles run side by side, each stopping at the sentinel.

A miss leaves (s, u, v) = (0, 0, 0) and triangle -1, as the reference's
code does (its `Hit` docstring says POW32 for s; its casts write 0)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .intersect import BIAS, POW32, mt_solve

CHUNK = 16
SYNC_EVERY = 16          # packet steps between the host's looks at whether a tile is left


class Hit(NamedTuple):
    suv: torch.Tensor       # [N, 3] (s, u, v); (0, 0, 0) on a miss
    triangle: torch.Tensor  # [N] int32 slot index, -1 on a miss


def _mt_chunk(v0, v1, v2, origin, direction, max_len, cull: bool, edge: float = BIAS):
    """Moeller-Trumbore of rays against triangles, broadcast: v0 / v1 / v2
    [..., C, 1, 3] against origin / direction [..., N, 3] give s, u, v,
    valid [..., C, N] with the accept window of glsl:123-158. `edge` is
    the lower bound of the u / v window: -BIAS on casts that stand in for
    the reference's watertight raster pass, +BIAS otherwise."""
    det, u, v, s = mt_solve(v0, v1, v2, origin.unsqueeze(-3), direction.unsqueeze(-3))
    valid = (det >= BIAS) if cull else (torch.abs(det) >= BIAS)
    valid &= (u >= edge) & (u <= 1.0)
    valid &= (v >= edge) & (u + v <= 1.0)
    valid &= (s <= max_len) & (s > BIAS)
    return s, u, v, valid


def _live_triangles(geometry: torch.Tensor):
    """(bool [n_slots]: a triangle before the first end sentinel, within the
    list's whole chunks; the number of chunks up to the last such
    triangle). The chunks after it hold no live triangle and cannot change
    a result, so the scans stop there (one read of the count by the host)."""
    n_slots = geometry.shape[0] // CHUNK * CHUNK
    kind = geometry[:n_slots, 10]
    live = (kind == 2.0) & (torch.cumsum((kind == 0.0).to(torch.int32), dim=0) == 0)
    idx = torch.nonzero(live)
    return live, (int(idx[-1, 0]) // CHUNK + 1) if idx.shape[0] else 0


def _verts(rows: torch.Tensor):
    """[..., 12] slot rows -> v0, v1, v2 [..., 1, 3]."""
    return (rows[..., None, 0:3], rows[..., None, 3:6], rows[..., None, 6:9])


def traverse_scan(geometry: torch.Tensor, origin: torch.Tensor, direction: torch.Tensor,
                  edge: float = BIAS) -> Hit:
    """Closest hit of every ray, a chunked linear scan (glsl:172-227)."""
    live, n_chunks = _live_triangles(geometry)
    n = origin.shape[0]
    min_len = torch.full((n,), POW32, dtype=torch.float32, device=origin.device)
    suv = torch.zeros((n, 3), dtype=torch.float32, device=origin.device)
    tri = torch.full((n,), -1, dtype=torch.int32, device=origin.device)
    for step in range(n_chunks):
        lo = step * CHUNK
        s, u, v, valid = _mt_chunk(*_verts(geometry[lo:lo + CHUNK]), origin, direction,
                                   min_len[None, :], cull=False, edge=edge)
        s_masked = torch.where(valid & live[lo:lo + CHUNK, None], s, POW32)
        best = torch.argmin(s_masked, dim=0)[None]                  # first of equal s
        best_s = torch.gather(s_masked, 0, best)[0]
        take = (best_s < POW32) & (best_s <= min_len)
        min_len = torch.where(take, best_s, min_len)
        picked = torch.stack([best_s, torch.gather(u, 0, best)[0],
                              torch.gather(v, 0, best)[0]], dim=-1)
        suv = torch.where(take[:, None], picked, suv)
        tri = torch.where(take, (lo + best[0]).to(torch.int32), tri)
    return Hit(suv=suv, triangle=tri)


def shadow_scan(geometry: torch.Tensor, origin: torch.Tensor, direction: torch.Tensor,
                max_len: torch.Tensor) -> torch.Tensor:
    """Front-face-culled any hit within max_len (glsl:231-280) -> bool [N]."""
    live, n_chunks = _live_triangles(geometry)
    shadowed = torch.zeros(origin.shape[0], dtype=torch.bool, device=origin.device)
    for step in range(n_chunks):
        lo = step * CHUNK
        _, _, _, valid = _mt_chunk(*_verts(geometry[lo:lo + CHUNK]), origin, direction,
                                   max_len[None, :], cull=True)
        shadowed |= (valid & live[lo:lo + CHUNK, None]).any(dim=0)
    return shadowed


def _tiles(x: torch.Tensor, tile: int) -> torch.Tensor:
    n = x.shape[0]
    if n % tile:
        raise ValueError(f"the packet casts take whole tiles: {n} rays, tile {tile}")
    return x.reshape(n // tile, tile, *x.shape[1:])


def _box_enter(row, origin, inv_dir, max_len):
    """bool [G, tile]: the ray enters the slot's box (glsl:161-167), with
    row [G, 12] holding each packet's slot, the box in columns 0:6."""
    t0 = (row[:, None, 0:3] - origin) * inv_dir
    t1 = (row[:, None, 3:6] - origin) * inv_dir
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    return (tmax >= torch.clamp_min(tmin, BIAS)) & (tmin < max_len)


def _packet_walk(geometry, n_packets: int, device, step_fn):
    """The list walk of ray packets, one cursor a packet. Each step reads
    the slot under every packet's cursor; `step_fn(row [G, 12], cursor [G],
    active [G])` updates the packets that are active and returns (the rays
    [G, tile] whose entry into the slot's box keeps its subtree, and
    done [G]: the packet needs no more slots). A packet skips an AABB
    subtree that none of those rays enters, and stops at the sentinel, at
    the list's end or once done; the host looks every SYNC_EVERY steps
    whether a packet is left."""
    n_slots = geometry.shape[0]
    cursor = torch.zeros(n_packets, dtype=torch.int64, device=device)
    ended = torch.zeros(n_packets, dtype=torch.bool, device=device)
    done = torch.zeros(n_packets, dtype=torch.bool, device=device)
    step = 0
    while True:
        active = (cursor < n_slots) & ~ended & ~done
        if step % SYNC_EVERY == 0 and not bool(active.any()):
            return
        row = geometry[torch.clamp_max(cursor, n_slots - 1)]
        kind = row[:, 10]
        enter, done = step_fn(row, cursor, active)
        skip_all = (kind == 1.0) & ~enter.any(dim=1)
        ended = ended | (active & (kind == 0.0))
        advance = torch.where(skip_all, row[:, 6].to(torch.int32).to(torch.int64) + 1, 1)
        cursor = torch.where(active, cursor + advance, cursor)
        step += 1


def traverse_coherent(geometry: torch.Tensor, origin: torch.Tensor, direction: torch.Tensor,
                      tile: int = 1024, edge: float = BIAS) -> Hit:
    """Closest hit by packets of `tile` consecutive rays (N a multiple of
    tile): glsl:172-227 with a shared cursor."""
    o, d = _tiles(origin, tile), _tiles(direction, tile)
    g = o.shape[0]
    inv_dir = 1.0 / d
    min_len = torch.full((g, tile), POW32, dtype=torch.float32, device=o.device)
    suv = torch.zeros((g, tile, 3), dtype=torch.float32, device=o.device)
    tri = torch.full((g, tile), -1, dtype=torch.int32, device=o.device)
    no_done = torch.zeros(g, dtype=torch.bool, device=o.device)

    def step_fn(row, cursor, active):
        nonlocal min_len, suv, tri
        enter = _box_enter(row, o, inv_dir, min_len)
        s, u, v, valid = _mt_chunk(*_verts(row[:, None]), o, d, min_len[:, None],
                                   cull=False, edge=edge)
        take = valid[:, 0] & ((row[:, 10] == 2.0) & active)[:, None]
        min_len = torch.where(take, s[:, 0], min_len)
        suv = torch.where(take[..., None], torch.stack([s[:, 0], u[:, 0], v[:, 0]], dim=-1), suv)
        tri = torch.where(take, cursor[:, None].to(torch.int32), tri)
        return enter, no_done

    _packet_walk(geometry, g, o.device, step_fn)
    n = origin.shape[0]
    return Hit(suv=suv.reshape(n, 3), triangle=tri.reshape(n))


def shadow_coherent(geometry: torch.Tensor, origin: torch.Tensor, direction: torch.Tensor,
                    max_len: torch.Tensor, tile: int = 1024) -> torch.Tensor:
    """Front-face-culled any hit within max_len by packets of `tile` rays;
    a packet stops once all its rays are shadowed. -> bool [N]."""
    o, d, ml = _tiles(origin, tile), _tiles(direction, tile), _tiles(max_len, tile)
    inv_dir = 1.0 / d
    shadowed = torch.zeros(ml.shape, dtype=torch.bool, device=o.device)

    def step_fn(row, cursor, active):
        nonlocal shadowed
        enter = _box_enter(row, o, inv_dir, ml) & ~shadowed
        _, _, _, valid = _mt_chunk(*_verts(row[:, None]), o, d, ml[:, None], cull=True)
        shadowed = shadowed | (valid[:, 0] & ((row[:, 10] == 2.0) & active)[:, None])
        return enter, shadowed.all(dim=1)

    _packet_walk(geometry, o.shape[0], o.device, step_fn)
    return shadowed.reshape(-1)
