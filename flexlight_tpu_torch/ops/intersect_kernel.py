"""Closest hit and any hit of a ray wavefront against all triangles:
kernel 1 of the port (csrc/intersect.cu).

Moeller-Trumbore in the bilinear form of flexlight_tpu/ops/traverse_mxu.py:
with the ray features f = [1, o, d, vec(d (x) o)], the four MT quantities
(det, u*det, v*det, s*det) of every (ray, triangle) pair are dot products
of f with constant per-triangle rows W[4, T, 16] (ops.intersect
`tri_rows`). `closest_hit_plain` / `any_hit_plain` are that function as
the [N, 16] @ [16, 4T] product in k order (ops.intersect `mt_products`)
plus the accept window, chunked over rays. The CUDA
kernels build each triangle's 16-float record from W in shared memory
(its 25 non-zero terms, ops/intersect_sparse.py `tri_record`), sum those
terms in W's k order and reject a pair exactly
before the division once det or a numerator's sign rules it out; the
sums equal W's but for a zero's sign, which no accept decision reads, so
the outputs are the plain versions'.

Ties in s go to the lowest triangle column (the TPU kernel's argmin).
Zero directions are replaced by +z, and a ray with max_len 0 (dead) hits
nothing (flexlight_tpu/ops/intersect_kernel.py `_prep_soa`, `alive`).
The TPU kernel's cluster-flag prepass is a conservative skip of triangle
tiles no ray of a ray tile can reach; it is scheduling and is not ported.
"""

from __future__ import annotations

import torch

from .. import _native
from .intersect import BIAS, POW32, mt_products, tri_rows


def build_w4(world_geom: torch.Tensor, id_buffer: torch.Tensor):
    """W as [4, T, 16] float32 (det/udet/vdet/sdet planes) and the
    drawable ids [T] int32 of its columns."""
    w4 = torch.stack(tri_rows(world_geom, id_buffer)).contiguous()
    return w4, id_buffer.to(torch.int32).contiguous()


def _safe_dirs(d3):
    """Zero directions -> +z, as the TPU kernel's ray prep does."""
    dead = (d3[0] * d3[0] + d3[1] * d3[1] + d3[2] * d3[2]) <= 0.0
    zero = torch.zeros_like(d3[0])
    one = torch.ones_like(d3[0])
    return (torch.where(dead, zero, d3[0]), torch.where(dead, zero, d3[1]),
            torch.where(dead, one, d3[2]))


def _chunks(n: int, t: int):
    step = max(1, (1 << 24) // max(4 * t, 1))
    return [(i, min(i + step, n)) for i in range(0, n, step)]


def closest_hit_plain(w4, ids, o3, d3, max_len, edge: float = BIAS):
    """Closest hit of N rays against all T triangles of W.

    w4 [4, T, 16] f32, ids [T] int32, o3/d3 3-tuples of [N] f32, max_len
    [N] f32 (0 = dead ray), edge: the u/v accept-window edge (-BIAS on
    primary casts, BIAS otherwise). Returns (s, u, v, tri): s/u/v [N] f32
    (0 on a miss), tri [N] int32 (drawable id, -1 on a miss)."""
    d3 = _safe_dirs(d3)
    n = max_len.shape[0]
    outs = []
    for a, b in _chunks(n, w4.shape[1]):
        o = tuple(c[a:b] for c in o3)
        d = tuple(c[a:b] for c in d3)
        det, udet, vdet, sdet = mt_products(w4, o, d)
        inv = 1.0 / det
        u = udet * inv
        v = vdet * inv
        s = sdet * inv
        valid = torch.abs(det) >= BIAS
        valid &= (u >= edge) & (u <= 1.0)
        valid &= (v >= edge) & (u + v <= 1.0)
        valid &= (s > BIAS) & (s <= max_len[a:b, None])
        s_masked = torch.where(valid, s, torch.full_like(s, POW32))
        best = torch.argmin(s_masked, dim=-1)[:, None]   # first column on ties

        def pick(x):
            return torch.gather(x, 1, best)[:, 0]

        hit = pick(s_masked) < POW32
        zero = torch.zeros_like(hit, dtype=torch.float32)
        tri = ids[best[:, 0]]
        outs.append((torch.where(hit, pick(s), zero), torch.where(hit, pick(u), zero),
                     torch.where(hit, pick(v), zero),
                     torch.where(hit, tri, torch.full_like(tri, -1))))
    return tuple(torch.cat([o[k] for o in outs]) for k in range(4))


def any_hit_plain(w4, o3, d3, max_len):
    """Front-face-culled any hit within max_len (glsl:143-158). Returns
    bool [N]."""
    d3 = _safe_dirs(d3)
    n = max_len.shape[0]
    outs = []
    for a, b in _chunks(n, w4.shape[1]):
        o = tuple(c[a:b] for c in o3)
        d = tuple(c[a:b] for c in d3)
        det, udet, vdet, sdet = mt_products(w4, o, d)
        inv = 1.0 / det
        u = udet * inv
        v = vdet * inv
        s = sdet * inv
        valid = det >= BIAS
        valid &= (u >= BIAS) & (u <= 1.0)
        valid &= (v >= BIAS) & (u + v <= 1.0)
        valid &= (s > BIAS) & (s <= max_len[a:b, None])
        outs.append(valid.any(dim=-1))
    return torch.cat(outs)


def ray_args(o3, d3, max_len, dev):
    n = max_len.shape[0]
    _native.require(max_len, "max_len", torch.float32, (n,), dev)
    for name, v in (("origin", o3), ("direction", d3)):
        if len(v) != 3:
            raise ValueError(f"{name}: expected 3 channels")
        for c in v:
            _native.require(c, name, torch.float32, (n,), dev)
    return n, [_native.ptr(c) for c in (*o3, *d3, max_len)]


def _closest_hit_launch(lib, stream, w4, ids, o3, d3, max_len, edge: float = BIAS):
    dev = max_len.device
    tp = w4.shape[1]
    _native.require(w4, "w4", torch.float32, (4, tp, 16), dev)
    _native.require(ids, "ids", torch.int32, (tp,), dev)
    n, ray_ptrs = ray_args(o3, d3, max_len, dev)
    s = torch.empty(n, dtype=torch.float32, device=dev)
    u = torch.empty_like(s)
    v = torch.empty_like(s)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    _native.check(lib.fl_closest_hit(
        _native.ptr(w4), tp, _native.ptr(ids), *ray_ptrs, float(edge), n,
        _native.ptr(s), _native.ptr(u), _native.ptr(v), _native.ptr(tri),
        stream), "closest_hit")
    return s, u, v, tri


def _any_hit_launch(lib, stream, w4, o3, d3, max_len):
    dev = max_len.device
    tp = w4.shape[1]
    _native.require(w4, "w4", torch.float32, (4, tp, 16), dev)
    n, ray_ptrs = ray_args(o3, d3, max_len, dev)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    _native.check(lib.fl_any_hit(_native.ptr(w4), tp, *ray_ptrs, n,
                                 _native.ptr(hit), stream), "any_hit")
    return hit


closest_hit = _native.Kernel("closest_hit", closest_hit_plain, _closest_hit_launch)
any_hit = _native.Kernel("any_hit", any_hit_plain, _any_hit_launch)
