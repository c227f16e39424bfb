"""Ray-primitive intersection constants and the scalar Moeller-Trumbore
tests (pathtracer_fragment.glsl:123-158), as in
flexlight_tpu/ops/intersect.py. Rays and triangles are [..., 3] float32
tensors; the accept windows match the reference exactly."""

from __future__ import annotations

import torch

BIAS = 0.0000152587890625  # 2^-16, glsl:8
POW32 = 4294967296.0


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _mt(v0, v1, v2, origin, direction):
    edge1 = v1 - v0
    edge2 = v2 - v0
    pvec = _cross(direction, edge2)
    det = _dot(edge1, pvec)
    inv_det = 1.0 / det
    tvec = origin - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, edge1)
    v = _dot(direction, qvec) * inv_det
    s = _dot(edge2, qvec) * inv_det
    return det, u, v, s


def moeller_trumbore(v0, v1, v2, origin, direction, max_len):
    """Two-sided test. Returns suv [..., 3]; suv[..., 0] == 0 on a miss."""
    det, u, v, s = _mt(v0, v1, v2, origin, direction)
    valid = torch.abs(det) >= BIAS
    valid &= (u >= BIAS) & (u <= 1.0)
    valid &= (v >= BIAS) & (u + v <= 1.0)
    valid &= (s <= max_len) & (s > BIAS)
    suv = torch.stack([s, u, v], dim=-1)
    return torch.where(valid[..., None], suv, torch.zeros_like(suv))


def moeller_trumbore_cull(v0, v1, v2, origin, direction, max_len):
    """Front-facing-only any-hit test. Returns bool [...]."""
    det, u, v, s = _mt(v0, v1, v2, origin, direction)
    hit = det >= BIAS
    hit &= (u >= BIAS) & (u <= 1.0)
    hit &= (v >= BIAS) & (u + v <= 1.0)
    hit &= (s <= max_len) & (s > BIAS)
    return hit
