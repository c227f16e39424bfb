"""Per-frame world-transform bake (flexlight_tpu/ops/geometry.py).

Transforms are baked into the geometry once per frame: triangles become
world-space triangles and BVH nodes conservative world-space boxes, so
traversal needs no transform logic (vertex transform:
pathtracer_vertex.glsl:65). The 3-term products are written out in the
order XLA's CPU dot takes them, so both packages bake the same floats.
"""

from __future__ import annotations

import torch

from .buffers import SceneBuffers


def _rotate(rot: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """rot [S, 3, 3] @ pts [S, P, 3] -> [S, P, 3]."""
    return torch.stack([
        rot[:, None, i, 0] * pts[..., 0] + rot[:, None, i, 1] * pts[..., 1]
        + rot[:, None, i, 2] * pts[..., 2] for i in range(3)], dim=-1)


def world_geometry(buffers: SceneBuffers) -> torch.Tensor:
    """geometry [S, 12] + transforms -> world-space geometry [S, 12]."""
    g = buffers.geometry
    t_idx = g[:, 9].to(torch.int64)
    rot = buffers.rotations[t_idx][:, 0]   # [S, 3, 3] forward rotation*scale
    pos = buffers.shifts[t_idx][:, 0]      # [S, 3]
    kind = g[:, 10]

    verts = g[:, 0:9].reshape(-1, 3, 3)
    world_verts = _rotate(rot, verts) + pos[:, None, :]

    # BVH nodes: transform the 8 box corners and re-box (conservative)
    mins, maxs = g[:, 0:3], g[:, 3:6]
    corners = torch.stack([
        torch.stack([maxs[:, a] if (c >> a) & 1 else mins[:, a] for a in range(3)],
                    dim=-1)
        for c in range(8)], dim=1)          # [S, 8, 3]
    world_corners = _rotate(rot, corners) + pos[:, None, :]
    w_min = world_corners.min(dim=1).values
    w_max = world_corners.max(dim=1).values

    is_tri = (kind == 2.0)[:, None]
    first9 = torch.where(is_tri, world_verts.reshape(-1, 9),
                         torch.cat([w_min, w_max, g[:, 6:9]], dim=-1))
    return torch.cat([first9, g[:, 9:]], dim=-1)
