"""Ray-primitive intersection constants and the scalar Moeller-Trumbore
tests (pathtracer_fragment.glsl:123-158), as in
flexlight_tpu/ops/intersect.py. Rays and triangles are [..., 3] float32
tensors; the accept windows match the reference exactly.

Also the MT test as one product, which every cast but scan / packet
shares: the four MT quantities are (bi)linear in the ray,

    det       = -d . n                     n  = e1 x e2
    u * det   = d . (e2 x (o - v0))
    v * det   = d . ((o - v0) x e1)
    s * det   = (o - v0) . n

so with the ray features f = [1, o, d, vec(d (x) o)] (`ray_features`)
every (ray, triangle) pair's four values are f . W with per triangle the
four constant rows of `tri_rows`; `mt_products` takes them in k order,
the order of the closest-hit / any-hit kernels (ops.intersect_kernel),
the mxu casts (ops.traverse_mxu) and the sparse record's terms
(ops.intersect_sparse)."""

from __future__ import annotations

import torch

BIAS = 0.0000152587890625  # 2^-16, glsl:8
POW32 = 4294967296.0


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def mt_solve(v0, v1, v2, origin, direction):
    """det, u, v, s of the geometric MT test, before any accept window."""
    edge1 = v1 - v0
    edge2 = v2 - v0
    pvec = cross(direction, edge2)
    det = _dot(edge1, pvec)
    inv_det = 1.0 / det
    tvec = origin - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = cross(tvec, edge1)
    v = _dot(direction, qvec) * inv_det
    s = _dot(edge2, qvec) * inv_det
    return det, u, v, s


def moeller_trumbore(v0, v1, v2, origin, direction, max_len):
    """Two-sided test. Returns suv [..., 3]; suv[..., 0] == 0 on a miss."""
    det, u, v, s = mt_solve(v0, v1, v2, origin, direction)
    valid = torch.abs(det) >= BIAS
    valid &= (u >= BIAS) & (u <= 1.0)
    valid &= (v >= BIAS) & (u + v <= 1.0)
    valid &= (s <= max_len) & (s > BIAS)
    suv = torch.stack([s, u, v], dim=-1)
    return torch.where(valid[..., None], suv, torch.zeros_like(suv))


def moeller_trumbore_cull(v0, v1, v2, origin, direction, max_len):
    """Front-facing-only any-hit test. Returns bool [...]."""
    det, u, v, s = mt_solve(v0, v1, v2, origin, direction)
    hit = det >= BIAS
    hit &= (u >= BIAS) & (u <= 1.0)
    hit &= (v >= BIAS) & (u + v <= 1.0)
    hit &= (s <= max_len) & (s > BIAS)
    return hit


def _skew(v):
    """Cross-product matrix rows, flattened: skew(a) @ b == cross(a, b)."""
    zero = torch.zeros_like(v[:, 0])
    return torch.stack([zero, -v[:, 2], v[:, 1],
                        v[:, 2], zero, -v[:, 0],
                        -v[:, 1], v[:, 0], zero], dim=-1)


def tri_rows(world_geom: torch.Tensor, id_buffer: torch.Tensor):
    """The four MT constant rows (det, udet, vdet, sdet), each [T, 16]."""
    tris = world_geom[id_buffer.long()]
    v0, v1, v2 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    e1 = v1 - v0
    e2 = v2 - v0
    n = cross(e1, e2)
    t = v0.shape[0]
    z1 = torch.zeros((t, 1), dtype=torch.float32, device=v0.device)
    z3 = torch.zeros((t, 3), dtype=torch.float32, device=v0.device)
    z9 = torch.zeros((t, 9), dtype=torch.float32, device=v0.device)
    # det = e1 . (d x e2) = -d . n
    det = torch.cat([z1, z3, -n, z9], dim=-1)
    # u*det = sum_ik d_i o_k skew(e2)[i,k] - d . cross(e2, v0)
    udet = torch.cat([z1, z3, -cross(e2, v0), _skew(e2)], dim=-1)
    # v*det = -sum_ik d_i o_k skew(e1)[i,k] - d . cross(v0, e1)
    vdet = torch.cat([z1, z3, -cross(v0, e1), -_skew(e1)], dim=-1)
    # s*det = o . n - v0 . n
    v0n = v0[:, 0] * n[:, 0] + v0[:, 1] * n[:, 1] + v0[:, 2] * n[:, 2]
    sdet = torch.cat([-v0n[:, None], n, z3, z9], dim=-1)
    return det, udet, vdet, sdet


def ray_features(o3, d3) -> torch.Tensor:
    """f = [1, o, d, vec(d (x) o)] : [N, 16]."""
    cols = [torch.ones_like(o3[0]), o3[0], o3[1], o3[2], d3[0], d3[1], d3[2]]
    cols += [d3[c] * o3[k] for c in range(3) for k in range(3)]
    return torch.stack(cols, dim=-1)


def mt_products(w4, o3, d3):
    """det, udet, vdet, sdet, each [N, T]: the product F[N, 16] @ W[16, 4T]
    of W given as [4, T, 16] planes, taken as 16 rank-1 updates in k order,
    in plain float32 (no BLAS call, so no TF32 either). A BLAS product sums
    in an order of its own, and the bilinear form's s of a shadow ray
    leaving a surface lies within that rounding of the BIAS accept edge; in
    k order every product and sum rounds as in the kernels' dot products,
    so the two agree bit for bit."""
    t = w4.shape[1]
    w = w4.permute(2, 1, 0).reshape(16, 4 * t)        # [16, 4T], column t*4+p
    f = ray_features(o3, d3)
    prod = f[:, 0, None] * w[0]
    for k in range(1, 16):
        prod = prod + f[:, k, None] * w[k]
    prod = prod.reshape(-1, t, 4)
    return prod[..., 0], prod[..., 1], prod[..., 2], prod[..., 3]
