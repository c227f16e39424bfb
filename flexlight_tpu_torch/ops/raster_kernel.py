"""The rasterizer's shading of one hit layer (models/rasterizer.py `_shade`,
rasterizer_fragment.glsl main) in three kernels (csrc/raster.cu) around
the scheme's shadow casts:

- `raster_surface`: the hit's world position, the origin of the layer's
  shadow rays, as SoA [3, N];
- `raster_rays`: light j's shadow rays from it, unit direction and length
  as [4, N];
- `raster_shade`: the surface again, the textures, Cook-Torrance of every
  light gated by its shadow flag, the translucency fade, Reinhard + gamma;
  rgb [N, 3] clamped and alpha [N].

The plain versions are the eager shading split at those two seams, the
same float operations in the same order (flexlight_tpu jits its frame, so
these kernels replace no TPU kernel: they stand in for XLA's fusion of
it). A miss (slot -1) is shaded as triangle 0, as in the reference."""

from __future__ import annotations

import torch

from .. import _native
from ..post.common import reinhard_gamma
from . import vec3 as v3
from .brdf import forward_trace, normalize
from .buffers import fetch_tex_val_table
from .fused_kernel import table_args


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


def _surface(geometry, rotations, hu, hv, slot):
    """(triangle [N] (a miss reads triangle 0), barycentric weights [N, 3],
    local position [N, 3] over the untransformed vertices (the vertex
    shader's varying `position`), forward rotation [N, 3, 3], transform
    index [N])."""
    n = hu.shape[0]
    tri = torch.clamp_min(slot, 0).long()
    uvw = torch.stack([1.0 - hu - hv, hu, hv], dim=-1)
    geom = geometry[tri]
    t_idx = geom[:, 9].long()
    local_pos = _bary(geom[:, 0:9].reshape(n, 3, 3), uvw)
    return tri, uvw, local_pos, rotations[t_idx][:, 0], t_idx


def raster_surface_plain(geometry, rotations, shifts, hu, hv, slot):
    """The world position of each hit, R p + shift (glsl:228), the origin
    of the layer's shadow rays (glsl:267-268): float32 [3, N]."""
    _, _, local_pos, rot_f, t_idx = _surface(geometry, rotations, hu, hv, slot)
    world_pos = _rotate(rot_f, local_pos) + shifts[t_idx][:, 0]
    return world_pos.T.contiguous()


def raster_rays_plain(origin, lights, j: int):
    """The shadow rays of light j from `origin` [3, N]: float32 [4, N], the
    unit direction toward the light, then the distance to it (the rays'
    max_len)."""
    d = tuple(lights[j, 0, c] - origin[c] for c in range(3))
    dist = v3.norm3(d)
    length = torch.clamp_min(dist, 1e-30)
    return torch.stack([d[0] / length, d[1] / length, d[2] / length, dist])


def raster_shade_plain(geometry, attributes, rotations, albedo_tab, pbr_tab, tpo_tab, lights,
                       ambient, cam, hu, hv, slot, shadowed, hdr: bool):
    """The layer's colour (rasterizer_fragment.glsl main): per light
    Cook-Torrance, added where the light is on and its shadow ray
    (`shadowed` [L, N] bool) is clear or the term is zero; translucency
    fade, Reinhard + gamma under `hdr`. Returns (rgb [N, 3] clamped, alpha
    [N]), the fragment shader's vec4(finalColor, 1 - 0.5 * tpo.x)
    (glsl:291)."""
    n = hu.shape[0]
    tri, uvw, local_pos, rot_f, _ = _surface(geometry, rotations, hu, hv, slot)
    attr = attributes[tri]
    smooth_normal = normalize(_rotate(rot_f, _bary(attr[:, 0:9].reshape(n, 3, 3), uvw)))
    bary = _bary(attr[:, 9:15].reshape(n, 3, 2), uvw)
    albedo = _tex(albedo_tab, bary, attr, 15, slice(18, 21))
    rme = _tex(pbr_tab, bary, attr, 16, slice(21, 24))
    tpo = _tex(tpo_tab, bary, attr, 17, slice(24, 27))

    final = rme[:, 2:3] + ambient[None, :]
    v = normalize(cam[None, :] - local_pos)
    for j in range(lights.shape[0]):
        light = lights[j, 0]
        strength = lights[j, 1, 0]
        local_color = forward_trace(albedo, rme, light[None, :] - local_pos, strength,
                                    smooth_normal, v)
        show = v3.norm3(v3.unstack3(local_color)) == 0.0
        add = (strength > 0.0) & (show | ~shadowed[j])
        final = torch.where(add[:, None], final + local_color, final)

    final = final * albedo
    peak = final.amax(dim=-1)
    t_factor = torch.clamp_max(1.0 + peak - tpo[:, 0], 1.0)[:, None]
    final = albedo * albedo + (final - albedo * albedo) * t_factor
    if hdr:
        final = reinhard_gamma(final)
    alpha = 1.0 - 0.5 * tpo[:, 0]
    return torch.clamp(final, 0.0, 1.0), alpha


def _hit_args(hu, hv, slot, dev):
    n = hu.shape[0]
    _native.require(hu, "hu", torch.float32, (n,), dev)
    _native.require(hv, "hv", torch.float32, (n,), dev)
    _native.require(slot, "slot", torch.int32, (n,), dev)
    return n, [_native.ptr(hu), _native.ptr(hv), _native.ptr(slot)]


def _require_scene(dev, geometry, rotations, attributes=None):
    _native.require(geometry, "geometry", torch.float32, (geometry.shape[0], 12), dev)
    _native.require(rotations, "rotations", torch.float32, (rotations.shape[0], 2, 3, 3), dev)
    if attributes is not None:
        _native.require(attributes, "attributes", torch.float32, (geometry.shape[0], 28), dev)


def _raster_surface_launch(lib, stream, geometry, rotations, shifts, hu, hv, slot):
    dev = hu.device
    _require_scene(dev, geometry, rotations)
    _native.require(shifts, "shifts", torch.float32, (rotations.shape[0], 2, 3), dev)
    n, hit = _hit_args(hu, hv, slot, dev)
    origin = torch.empty((3, n), dtype=torch.float32, device=dev)
    _native.check(lib.fl_raster_surface(_native.ptr(geometry), _native.ptr(rotations),
                                        _native.ptr(shifts), *hit, n, _native.ptr(origin),
                                        stream), "raster_surface")
    return origin


def _raster_rays_launch(lib, stream, origin, lights, j: int):
    dev = origin.device
    n = origin.shape[1]
    _native.require(origin, "origin", torch.float32, (3, n), dev)
    _native.require(lights, "lights", torch.float32, (lights.shape[0], 2, 3), dev)
    if not 0 <= j < lights.shape[0]:
        raise IndexError(f"raster_rays: light {j} of {lights.shape[0]}")
    rays = torch.empty((4, n), dtype=torch.float32, device=dev)
    _native.check(lib.fl_raster_rays(_native.ptr(origin), _native.ptr(lights[j, 0]), n,
                                     _native.ptr(rays), stream), "raster_rays")
    return rays


def _raster_shade_launch(lib, stream, geometry, attributes, rotations, albedo_tab, pbr_tab,
                         tpo_tab, lights, ambient, cam, hu, hv, slot, shadowed, hdr: bool):
    dev = hu.device
    _require_scene(dev, geometry, rotations, attributes)
    n_lights = lights.shape[0]
    _native.require(lights, "lights", torch.float32, (n_lights, 2, 3), dev)
    _native.require(ambient, "ambient", torch.float32, (3,), dev)
    _native.require(cam, "cam", torch.float32, (3,), dev)
    n, hit = _hit_args(hu, hv, slot, dev)
    _native.require(shadowed, "shadowed", torch.bool, (n_lights, n), dev)
    tables = (table_args(albedo_tab, "albedo_tab", dev) + table_args(pbr_tab, "pbr_tab", dev)
              + table_args(tpo_tab, "tpo_tab", dev))
    rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
    alpha = torch.empty(n, dtype=torch.float32, device=dev)
    _native.check(lib.fl_raster_shade(
        _native.ptr(geometry), _native.ptr(attributes), _native.ptr(rotations), *tables,
        _native.ptr(lights), n_lights, _native.ptr(ambient), _native.ptr(cam), *hit,
        _native.ptr(shadowed), int(bool(hdr)), n, _native.ptr(rgb), _native.ptr(alpha),
        stream), "raster_shade")
    return rgb, alpha


raster_surface = _native.Kernel("raster_surface", raster_surface_plain, _raster_surface_launch)
raster_rays = _native.Kernel("raster_rays", raster_rays_plain, _raster_rays_launch)
raster_shade = _native.Kernel("raster_shade", raster_shade_plain, _raster_shade_launch)
