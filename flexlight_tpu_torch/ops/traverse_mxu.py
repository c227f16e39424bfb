"""Moeller-Trumbore as one product: the reference's scheme="mxu"
(flexlight_tpu/ops/traverse_mxu.py), its CPU route up to 8192 triangles,
in plain float32 PyTorch.

Every (ray, triangle) pair's four MT quantities are one product F[N, 16]
@ W[16, 4T] of the ray features and the triangles' constant rows
(`build_tri_matrix`; ops.intersect `ray_features`, `tri_rows`).
flexlight_tpu takes it on the MXU; here it is ops.intersect.mt_products,
16 rank-1 updates in k order in plain float32 (no BLAS, no TF32): the
order of the closest-hit and any-hit kernels, so a mxu frame is the
scheme="kernel" frame of the same scene.

The semantics stay the reference's, which differ from the kernels':
a zero direction is not replaced by +z, a dead ray is tested like a live
one (the bounce loop masks its hit), and the closest hit has no max_len
(the shadow cast keeps s <= max_len). The hit is id_buffer[best], s / u /
v are zero on a miss, and a tie in s goes to the first triangle.

The reference bounds its [block, T] epilogue with 262,144-ray blocks; here
the block comes from a memory budget (MXU_BLOCK_VALUES per [block, 4T]
product: at 8192 triangles one such tensor of 262,144 rays would take
32 GiB). The result does not depend on the block."""

from __future__ import annotations

import torch

from .intersect import BIAS, POW32, mt_products, tri_rows
from .traverse import Hit

MXU_BLOCK_VALUES = 1 << 25   # float32 values of one [block, 4T] product (128 MiB)


def build_tri_matrix(world_geom: torch.Tensor, id_buffer: torch.Tensor) -> torch.Tensor:
    """W [16, 4T]: column t * 4 + p holds triangle t's row p of `tri_rows`
    (det, udet, vdet, sdet)."""
    w = torch.stack(tri_rows(world_geom, id_buffer), dim=1)   # [T, 4, 16]
    return w.reshape(-1, 16).T


def _planes(w: torch.Tensor) -> torch.Tensor:
    """W [16, 4T] -> [4, T, 16] (det, udet, vdet, sdet planes)."""
    return w.T.reshape(-1, 4, 16).permute(1, 0, 2)


def _blocks(n: int, t: int, block: int | None):
    if block is None:
        block = max(1, MXU_BLOCK_VALUES // max(4 * t, 1))
    return [(a, min(a + block, n)) for a in range(0, n, block)]


def _soa(x: torch.Tensor):
    return x[:, 0], x[:, 1], x[:, 2]


def _closest_hit_block(w4, id_buffer, o3, d3, edge: float):
    det, udet, vdet, sdet = mt_products(w4, o3, d3)
    inv = 1.0 / det
    u = udet * inv
    v = vdet * inv
    s = sdet * inv
    # the full two-sided accept window (glsl:123-139); NaNs (det == 0) reject
    valid = torch.abs(det) >= BIAS
    valid &= (u >= edge) & (u <= 1.0)
    valid &= (v >= edge) & (u + v <= 1.0)
    valid &= s > BIAS
    s_masked = torch.where(valid, s, torch.full_like(s, POW32))
    best = torch.argmin(s_masked, dim=-1)[:, None]       # the first minimum
    best_s = torch.gather(s_masked, 1, best)[:, 0]
    hit = best_s < POW32
    suv = torch.stack([best_s, torch.gather(u, 1, best)[:, 0],
                       torch.gather(v, 1, best)[:, 0]], dim=-1)
    suv = torch.where(hit[:, None], suv, 0.0)
    tri = torch.where(hit, id_buffer[best[:, 0]].to(torch.int32), -1)
    return suv, tri


def _shadow_block(w4, o3, d3, max_len):
    det, udet, vdet, sdet = mt_products(w4, o3, d3)
    inv = 1.0 / det
    u = udet * inv
    v = vdet * inv
    s = sdet * inv
    # front-face-culled any hit (glsl:143-158)
    valid = det >= BIAS
    valid &= (u >= BIAS) & (u <= 1.0)
    valid &= (v >= BIAS) & (u + v <= 1.0)
    valid &= (s > BIAS) & (s <= max_len[:, None])
    return valid.any(dim=-1)


def traverse_mxu(w, id_buffer, origin, direction, block: int | None = None,
                 edge: float = BIAS) -> Hit:
    """Closest hit of N rays (origin, direction [N, 3]) against all T
    triangles of W [16, 4T] (`build_tri_matrix`); `block` rays at a time
    (default: from MXU_BLOCK_VALUES). Returns Hit(suv [N, 3], triangle
    [N] int32: id_buffer[best], -1 on a miss)."""
    w4 = _planes(w)
    o3, d3 = _soa(origin), _soa(direction)
    outs = [_closest_hit_block(w4, id_buffer, tuple(c[a:b] for c in o3),
                               tuple(c[a:b] for c in d3), edge)
            for a, b in _blocks(origin.shape[0], w4.shape[1], block)]
    return Hit(suv=torch.cat([o[0] for o in outs]), triangle=torch.cat([o[1] for o in outs]))


def shadow_mxu(w, origin, direction, max_len, block: int | None = None) -> torch.Tensor:
    """Any hit within max_len [N] (front faces only): bool [N]."""
    w4 = _planes(w)
    o3, d3 = _soa(origin), _soa(direction)
    return torch.cat([_shadow_block(w4, tuple(c[a:b] for c in o3),
                                    tuple(c[a:b] for c in d3), max_len[a:b])
                      for a, b in _blocks(origin.shape[0], w4.shape[1], block)])
