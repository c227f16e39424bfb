"""The rasterizer's frame (flexlight_tpu_torch/models/rasterizer.py at
commit 0b403bb): direct lighting of the primary visibility found by ray
casts, Cook-Torrance per light with a shadow ray each, translucency fade,
Reinhard + gamma, up to `layers` translucent hit layers blended in draw
order, and FXAA. A frozen copy of `_shade`, `_blend_layers`, `_casts` and
`raster_frame` over the frozen ops; TAA and the renderer class are left
out, and the casts and FXAA come from a kernel set of plain versions.

`raster_frame(..., layer_out=)` takes the control's rounding of each
layer's shaded rgb and alpha (the identity gives the program's frame).

Reference quirks kept: forwardTrace gets the light vector from the local
(untransformed) position and the view vector camera - localPosition
(rasterizer_fragment.glsl:269), while the shadow ray leaves from the world
position (glsl:267-268); every light casts its shadow ray, active or not,
for every pixel, a miss's from triangle 0's point."""

from __future__ import annotations

import torch

from ..ops import vec3 as v3
from ..ops.brdf import forward_trace, normalize
from ..ops.buffers import fetch_tex_val_table
from ..ops.geometry import world_geometry
from ..ops.intersect import BIAS
from ..ops.pathtrace import camera_rays, inverse_view, scheme_casts
from ..post.common import quantize_rgba8, reinhard_gamma

# "auto" takes the sparse worklist casts from this many triangles on, else
# the dense kernel casts (models/rasterizer.py Rasterizer.resolved_scheme)
SPARSE_MIN_TRIS = 4096
SCHEMES = ("kernel", "sparse", "scan", "packet", "mxu")


def resolved_scheme(scheme: str, triangles: int) -> str:
    if scheme == "auto":
        return "sparse" if triangles >= SPARSE_MIN_TRIS else "kernel"
    return scheme


def resolved_layers(buffers, layers: int = 4) -> int:
    """`layers` on a scene with translucent material (a triangle's
    attributes[:, 24], or a TPO atlas larger than its 1x1 default), else 1
    (Rasterizer.update_scene, resolved_layers)."""
    translucent = bool((buffers.attributes[:, 24] > 0.0).any()) or \
        buffers.tpo_atlas.numel() > 3
    return max(int(layers), 1) if translucent else 1


def _bary(rows: torch.Tensor, uvw: torch.Tensor) -> torch.Tensor:
    """sum_v rows[:, v] * uvw[:, v] over the three vertices: rows [N, 3, C]."""
    return rows[:, 0] * uvw[:, 0:1] + rows[:, 1] * uvw[:, 1:2] + rows[:, 2] * uvw[:, 2:3]


def _rotate(rot: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """rot [N, 3, 3] @ p [N, 3]."""
    return rot[:, :, 0] * p[:, 0:1] + rot[:, :, 1] * p[:, 1:2] + rot[:, :, 2] * p[:, 2:3]


def _tex(table, bary, attr, num_col: int, default_cols: slice) -> torch.Tensor:
    default = attr[:, default_cols]
    return torch.stack(fetch_tex_val_table(table, bary[:, 0], bary[:, 1], attr[:, num_col],
                                           (default[:, 0], default[:, 1], default[:, 2])),
                       dim=-1)


def _shade(buffers, cam_pos, hit, shadow_fn, config):
    """Shade one primary-visibility layer (rasterizer_fragment.glsl main).
    `hit` is (s, u, v, slot) of [N]. Returns (rgb [N, 3] clamped, alpha
    [N])."""
    _, hu, hv, slot = hit
    n = hu.shape[0]
    tri = torch.clamp_min(slot, 0).long()
    uvw = torch.stack([1.0 - hu - hv, hu, hv], dim=-1)
    geom = buffers.geometry[tri]
    t_idx = geom[:, 9].long()
    rot_f = buffers.rotations[t_idx][:, 0]
    shift_f = buffers.shifts[t_idx][:, 0]
    local_pos = _bary(geom[:, 0:9].reshape(n, 3, 3), uvw)
    world_pos = _rotate(rot_f, local_pos) + shift_f

    attr = buffers.attributes[tri]
    smooth_normal = normalize(_rotate(rot_f, _bary(attr[:, 0:9].reshape(n, 3, 3), uvw)))
    bary = _bary(attr[:, 9:15].reshape(n, 3, 2), uvw)
    albedo = _tex(buffers.albedo_tab, bary, attr, 15, slice(18, 21))
    rme = _tex(buffers.pbr_tab, bary, attr, 16, slice(21, 24))
    tpo = _tex(buffers.tpo_tab, bary, attr, 17, slice(24, 27))

    final = rme[:, 2:3] + buffers.ambient[None, :]
    v = normalize(cam_pos[None, :] - local_pos)
    for j in range(buffers.lights.shape[0]):
        light = buffers.lights[j, 0]
        strength = buffers.lights[j, 1, 0]
        local_color = forward_trace(albedo, rme, light[None, :] - local_pos, strength,
                                    smooth_normal, v)
        show = v3.norm3(v3.unstack3(local_color)) == 0.0
        d = light[None, :] - world_pos
        dist = v3.norm3(v3.unstack3(d))
        shadowed = shadow_fn(world_pos, d / torch.clamp_min(dist, 1e-30)[:, None], dist)
        add = (strength > 0.0) & (show | ~shadowed)
        final = torch.where(add[:, None], final + local_color, final)

    final = final * albedo
    peak = final.amax(dim=-1)
    t_factor = torch.clamp_max(1.0 + peak - tpo[:, 0], 1.0)[:, None]
    final = albedo * albedo + (final - albedo * albedo) * t_factor
    if config.hdr:
        final = reinhard_gamma(final)
    alpha = 1.0 - 0.5 * tpo[:, 0]
    return torch.clamp(final, 0.0, 1.0), alpha


# static compare-swap networks sorting k layers by draw order
_SORT_PAIRS = {1: [], 2: [(0, 1)], 3: [(0, 1), (1, 2), (0, 1)],
               4: [(0, 1), (2, 3), (0, 2), (1, 3), (1, 2)]}


def _blend_layers(layers_data):
    """GL's raster state over K depth-ordered hit layers a pixel: depth
    test LESS with depth writes and blending (ONE, ONE_MINUS_SRC_ALPHA,
    ONE, ONE) in draw order (the geometry slot order), each write clamped
    by the RGBA8 canvas. `layers_data` holds (dist, slot, rgb, alpha,
    covered) per layer; returns (rgb [N, 3], alpha [N])."""
    layers = list(layers_data)
    k = len(layers)
    key = [torch.where(layer[4], layer[1], 2 ** 30) for layer in layers]

    def pick(cond, a, b):
        return torch.where(cond[:, None] if b.ndim == 2 else cond, a, b)

    for i, j in _SORT_PAIRS.get(k, [(a, b) for a in range(k) for b in range(a + 1, k)]):
        take = key[j] < key[i]
        key[i], key[j] = torch.where(take, key[j], key[i]), torch.where(take, key[i], key[j])
        layers[i], layers[j] = (tuple(pick(take, b, a) for a, b in zip(layers[i], layers[j])),
                                tuple(pick(take, a, b) for a, b in zip(layers[i], layers[j])))

    n = layers[0][0].shape[0]
    dev = layers[0][0].device
    z = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    rgb = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    a_dst = torch.zeros((n,), dtype=torch.float32, device=dev)
    for dist, _slot, src_rgb, src_a, covered in layers:
        passes = covered & (dist < z)
        blended = torch.clamp(src_rgb + rgb * (1.0 - src_a[:, None]), 0.0, 1.0)
        rgb = torch.where(passes[:, None], blended, rgb)
        a_dst = torch.where(passes, torch.clamp(src_a + a_dst, 0.0, 1.0), a_dst)
        z = torch.where(passes, dist, z)
    return rgb, a_dst


def _casts(scheme: str, buffers, world_geom, kernels, tile: int):
    """(traverse_fn(o, d) -> (s, u, v, slot), shadow_fn(o, d, max_len) ->
    bool), rays as [N, 3] rows, over the path tracer's casts of `scheme`,
    unhinted; every closest-hit cast takes the relaxed edge window -BIAS,
    and the worklist casts' drawable indices are mapped to slots."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; the rasterizer takes {SCHEMES}")
    traverse_soa, shadow_soa = scheme_casts(scheme, buffers, world_geom, kernels, tile)

    def traverse_fn(o, d):
        s, u, v, tri = traverse_soa(v3.unstack3(o), v3.unstack3(d), edge=-BIAS)
        if scheme == "sparse":
            tri = torch.where(tri >= 0, buffers.id_buffer[torch.clamp_min(tri, 0).long()], -1)
        return s, u, v, tri

    def shadow_fn(o, d, max_len):
        return shadow_soa(v3.unstack3(o), v3.unstack3(d), max_len)

    return traverse_fn, shadow_fn


def raster_frame(buffers, cam_pos, view, width: int, height: int, config, kernels,
                 scheme: str = "kernel", tile: int = 1024, layers: int = 1,
                 layer_out=None):
    """One frame's display [H, W, 3] in [0, 1], with FXAA where the config
    asks for it (a caller rejects TAA); `kernels` holds the casts' and
    FXAA's plain versions."""
    dev = buffers.geometry.device
    cam_pos = torch.as_tensor(cam_pos, dtype=torch.float32, device=dev)
    world_geom = world_geometry(buffers)
    traverse_fn, shadow_fn = _casts(scheme, buffers, world_geom, kernels, tile)
    o3, d3, _ = camera_rays(width, height, cam_pos, inverse_view(view))
    origin, direction = torch.stack(o3, dim=-1), torch.stack(d3, dim=-1)

    layers_data = []
    o = origin
    cum = torch.zeros(origin.shape[0], dtype=torch.float32, device=dev)
    for layer in range(layers):
        hit = traverse_fn(o, direction)
        rgb_l, a_l = _shade(buffers, cam_pos, hit, shadow_fn, config)
        if layer_out is not None:
            rgb_l, a_l = layer_out(rgb_l), layer_out(a_l)
        dist_l = cum + hit[0]
        layers_data.append((dist_l, hit[3], rgb_l, a_l, hit[3] != -1))
        if layer + 1 < layers:
            o = o + direction * hit[0][:, None]
            cum = dist_l

    if layers == 1:
        _, _, rgb_l, a_l, covered = layers_data[0]
        rgb = torch.where(covered[:, None], rgb_l, 0.0)
        a = torch.where(covered, a_l, 0.0)
    else:
        rgb, a = _blend_layers(layers_data)
    display = rgb.reshape(height, width, 3)
    alpha_img = a.reshape(height, width)

    if config.antialiasing == "fxaa":
        aa_in = torch.cat([quantize_rgba8(display), quantize_rgba8(alpha_img)[..., None]],
                          dim=-1)
        display = kernels.fxaa(aa_in)[..., 0:3]
    return torch.clamp(display, 0.0, 1.0)
