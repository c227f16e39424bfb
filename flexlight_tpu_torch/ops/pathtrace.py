"""Wavefront path tracer core (flexlight_tpu/ops/pathtrace.py).

One function over the whole ray batch [N = H*W] replaces the reference's
per-pixel fragment shader (pathtracer_fragment.glsl:400-646): primary hits
from camera rays, the bounce loop with per-ray kill masks, next-event
estimation by weighted reservoir over all lights with one shadow ray, and
the 6-target MRT contract (glsl:601-646) in float32.

The bounce is kept as the reference's stage split, bounce_carry_init ->
bounce_pre -> bounce_tex -> bounce_shade -> bounce_apply -> bounce_commit
(composed by bounce_post). scheme="kernel" runs it as plain tensor code
with the traversals in the closest-hit / any-hit kernels of
ops.intersect_kernel, scheme="sparse" the same around the worklist casts
of ops.intersect_sparse (large scenes), scheme="scan" / "packet" the same
around the plain casts of ops.traverse, scheme="mxu" / "clustered" the
same around the plain casts of ops.traverse_mxu / ops.traverse_clustered
(flexlight_tpu's CPU routes); scheme="fused_split" (ops.fused)
runs everything but bounce_tex in two fused kernels whose plain versions
are built from the same stages, and scheme="fused" the whole frame in
one kernel whose plain version is the fused_split frame. On the kernel
and sparse schemes the shading may run in the kernels of ops.shade
instead (bounce_shade, or bounce_pre + a trivial bounce_tex +
bounce_shade), through light_trace's hooks: on a CUDA device by default,
where the scene allows (render_mrt's `shade_kernel`).

The carry has no counterpart of flexlight_tpu's `original_id_acc`: no
render target reads it.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..utils.timing import span
from . import vec3 as v3
from .brdf import SQRT3, forward_trace_soa, pow5
from .buffers import SceneBuffers, fetch_tex_val_table
from .geometry import world_geometry
from .intersect import BIAS, POW32
from .rng import f32, noise4

INV_255 = 1.0 / 255.0
INV_PI = 0.3183098861837907
BLOCK_TILE_MIN_TRIS = 2048   # flexlight_tpu/ops/pathtrace.py:58


class MRT(NamedTuple):
    """Flat per-pixel render targets, fp32 (glsl:74-79)."""
    color: torch.Tensor          # [N, 3] finalColor (originalColor NOT folded in)
    glass: torch.Tensor          # [N] glassFilter
    original_color: torch.Tensor  # [N, 3] first-hit albedo product
    original_w: torch.Tensor     # [N] min(originalRMEx, firstRayLength) + 1/255
    render_id: torch.Tensor      # [N, 4] packed normal/rme + light/shadow in w
    original_id_w: torch.Tensor  # [N] originalTPOx + 1/255 (glsl:639)
    location_id: torch.Tensor    # [N, 4] mod of local position (glsl:641-642)
    alpha: torch.Tensor          # [N] coverage (0 where no primary hit)


def to_4bit_representation(a, b):
    """Pack two [0,1] floats into the high/low nibbles of one byte
    (glsl:91-95)."""
    aui = (a * 255.0).to(torch.int64) & 240
    bui = ((b * 255.0).to(torch.int64) & 240) >> 4
    return (aui | bui).to(torch.float32) * INV_255


def combine_normal_rme_soa(n3, rough, metal, emis):
    """4-bit spherical normal + rme packing for the id channel
    (glsl:97-105) -> 3 [N] channels."""
    phi = torch.atan2(n3[2], n3[0]) * INV_PI * 0.5 + 0.5
    theta = torch.atan2(n3[0], n3[1]) * INV_PI * 0.5 + 0.5
    return (to_4bit_representation(phi, theta), rough,
            to_4bit_representation(metal, emis))


def sample_cos(s: int) -> float:
    """cos(s), the noise phase of sample `s` (glsl:611-612), as the
    float32 nearest to the true value, computed on the host: torch's
    float32 cos is an ulp off at s = 1, and the counter RNG hashes the
    phase's bits, so an ulp changes every random number of the sample."""
    return float(np.float32(math.cos(s)))


def inverse_view(view_matrix) -> torch.Tensor:
    """The inverse of the camera's 3x3 view matrix, in float32 on the
    host (the matrix comes from the host each frame: inverting it there
    spares the card a round trip)."""
    return torch.linalg.inv(torch.as_tensor(view_matrix, dtype=torch.float32).cpu())


def upload(values, device) -> torch.Tensor:
    """A frame's small host values (the camera position, the inverse view,
    the seed) as float32 on `device`. To a CUDA device they go through
    pinned memory with non_blocking=True: a copy from pageable memory
    synchronizes the stream, so each frame's first upload would wait for
    every frame still queued, and a pipelined fetch
    (models.pathtracer.PathTracer.pipelined) would overlap nothing."""
    t = torch.as_tensor(values, dtype=torch.float32)
    if t.device.type == "cpu" and torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def camera_rays(width: int, height: int, position: torch.Tensor,
                inv_view: torch.Tensor, row0: int = 0, rows: int | None = None):
    """Camera rays in place of the reference's instanced raster pass:
    pixel centres map to the NDC the vertex shader produces
    (pathtracer_vertex.glsl:66-68); viewMatrix @ dir = (ndc, 1), so
    dir = inv_view @ (ndc, 1) (inv_view: `inverse_view`, on any device).
    `row0` / `rows` select a horizontal strip of the image (the unit of
    tile sharding, parallel.tile_sharding); the row index is arange(rows)
    + row0 before the + 0.5, as flexlight_tpu builds it, so the strip's
    rays are the whole frame's rows bit for bit. Returns (origin3, dir3,
    ndc2), SoA channels of [N = rows * W]."""
    dev = position.device
    rows = height if rows is None else rows
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width * 2.0 - 1.0
    row_idx = torch.arange(rows, dtype=torch.float32, device=dev) + float(row0)
    py = 1.0 - (row_idx + 0.5) / height * 2.0
    ndc_y, ndc_x = torch.meshgrid(py, px, indexing="ij")
    ndc = (ndc_x.reshape(-1), ndc_y.reshape(-1))
    inv = inv_view.to(dev)
    raw = tuple(ndc[0] * inv[c, 0] + ndc[1] * inv[c, 1] + inv[c, 2] for c in range(3))
    # brdf.normalize of the reference divides by the norm (normalize3
    # multiplies by its reciprocal, which rounds differently)
    norm = torch.clamp_min(v3.norm3(raw), 1e-30)
    direction = tuple(c / norm for c in raw)
    origin = tuple(position[c].expand(direction[0].shape) for c in range(3))
    return origin, direction, ndc


class ReservoirPick(NamedTuple):
    """Reservoir selection (glsl:400-447): the shadow-ray request plus what
    reservoir_finish consumes after the shadow test."""
    local_color: tuple
    res_num: torch.Tensor
    show_color: torch.Tensor
    show_shadow: torch.Tensor
    offset_target: tuple
    light_dir: tuple            # unit direction to the selected light
    max_len: torch.Tensor       # distance to the selected light


def reservoir_finish(pick: ReservoirPick, emis, shadowed):
    """Reservoir epilogue after the shadow test (glsl:448-461)."""
    in_shadow = ~pick.show_color & (pick.show_shadow | shadowed)
    id_w = (torch.remainder(pick.res_num, 128) * 2).to(torch.float32) * INV_255
    id_w = id_w + torch.where(in_shadow, INV_255, 0.0)
    keep = pick.show_color | ~in_shadow
    e3 = (emis, emis, emis)
    return v3.where3(keep, v3.add3(pick.local_color, e3), e3), id_w


def reservoir_sample(buffers: SceneBuffers, albedo3, rough, metal, emis,
                     origin3, unit_dir3, random_vec4, n_rough3, n_smooth3,
                     geometry_offset, random_seed, shadow_soa, alive_mask=None,
                     rng_mode: str = "hash"):
    """Weighted reservoir NEE over all lights plus one shadow ray
    (glsl:400-461): reservoir_select -> shadow_soa -> reservoir_finish.
    Returns (color 3-tuple, id_w [N])."""
    pick = reservoir_select(buffers, albedo3, rough, metal, emis, origin3,
                            unit_dir3, random_vec4, n_rough3, n_smooth3,
                            geometry_offset, random_seed, rng_mode=rng_mode)
    shadowed = shadow_soa(pick.offset_target, pick.light_dir, pick.max_len,
                          alive=alive_mask)
    return reservoir_finish(pick, emis, shadowed)


def reservoir_select(buffers: SceneBuffers, albedo3, rough, metal, emis,
                     origin3, unit_dir3, random_vec4, n_rough3, n_smooth3,
                     geometry_offset, random_seed,
                     rng_mode: str = "hash") -> ReservoirPick:
    """The reservoir light loop and selection, up to (and excluding) the
    shadow ray (glsl:400-447). flexlight_tpu unrolls this loop below
    SCAN_LIGHTS_MIN = 16 lights and scans it above, for compile time; run
    eagerly both are the same sequential loop over the lights, and so is
    this one."""
    shp = origin3[0].shape
    zero = torch.zeros(shp, dtype=torch.float32, device=origin3[0].device)
    local_color = (zero, zero, zero)
    res_length = zero
    total_weight = zero
    res_num = torch.zeros(shp, dtype=torch.int32, device=zero.device)
    res_weight = zero
    res_dir = (zero, zero, zero)
    lr = noise4(random_vec4[2], random_vec4[3], BIAS, random_seed, mode=rng_mode)[0:2]
    v = v3.neg3(unit_dir3)
    for j in range(buffers.lights.shape[0]):
        row = buffers.lights[j]
        strength = row[1, 0]
        variation = row[1, 1]
        active = strength > 0.0  # skip dead lights (glsl:415)
        light = tuple(row[0, c] + random_vec4[c] * variation for c in range(3))
        d = v3.sub3(light, origin3)
        cfl = forward_trace_soa(albedo3, rough, metal, emis, d, strength, n_rough3, v)
        weight = v3.norm3(cfl)
        local_color = v3.where3(active, v3.add3(local_color, cfl), local_color)
        res_length = torch.where(active, res_length + 1.0, res_length)
        total_weight = torch.where(active, total_weight + weight, total_weight)
        sel = active & (torch.abs(lr[1]) * total_weight <= weight)
        res_num = torch.where(sel, j, res_num)
        res_weight = torch.where(sel, weight, res_weight)
        res_dir = v3.where3(sel, d, res_dir)
        nxt = noise4(lr[0], lr[1], BIAS, random_seed, mode=rng_mode)[2:4]
        lr = (torch.where(active, nxt[0], lr[0]), torch.where(active, nxt[1], lr[1]))

    unit_light_dir = v3.normalize3(res_dir)
    return ReservoirPick(
        local_color=local_color, res_num=res_num,
        show_color=(res_length == 0.0) | (res_weight == 0.0),
        show_shadow=v3.dot3(n_smooth3, unit_light_dir) <= BIAS,
        offset_target=v3.add3(origin3, v3.scale3(n_smooth3, geometry_offset)),
        light_dir=unit_light_dir, max_len=v3.norm3(res_dir))


def build_material_table(buffers: SceneBuffers, world_geom) -> torch.Tensor:
    """Per-triangle shading row [S, 49]: world geometry (12), attributes
    (28), forward rotation (9)."""
    t_idx = buffers.geometry[:, 9].to(torch.int64)
    rot_f = buffers.rotations[t_idx][:, 0].reshape(-1, 9)
    return torch.cat([world_geom, buffers.attributes, rot_f], dim=1)


def fetch_rows_t(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """mat[idx] with a leading channel axis: [C, N], each row contiguous."""
    return torch.index_select(mat.T.contiguous(), 1, idx.reshape(-1).long())


class BounceCarry(NamedTuple):
    """Loop-carried wavefront state of the bounce loop (glsl:464-599 locals
    plus the shader globals threaded through `aux`)."""
    alive: torch.Tensor
    tri: torch.Tensor
    hs: torch.Tensor
    hu: torch.Tensor
    hv: torch.Tensor
    ray_origin: tuple
    ray_dir: tuple
    last_hit_point: tuple
    importancy: tuple
    original_color: tuple
    dont_filter: torch.Tensor
    final_color: tuple
    render_id: tuple
    glass: torch.Tensor
    original_rme_x: torch.Tensor
    original_tpo_x: torch.Tensor
    first_ray_length: torch.Tensor


class BounceSurface(NamedTuple):
    """Per-bounce surface quantities of bounce_pre, read after the texture
    fetch."""
    m: torch.Tensor
    smooth_normal: tuple
    geometry_offset: torch.Tensor
    bary_u: torch.Tensor
    bary_v: torch.Tensor
    tex_nums: tuple
    inline_albedo: tuple
    inline_rme: tuple
    inline_tpo: tuple


class ShadeRequest(NamedTuple):
    """bounce_shade -> bounce_apply: the NEE shadow-ray request (pick) and
    the shading-frame values the post-shadow stage reads."""
    m: torch.Tensor
    ray_dir: tuple              # recomputed incoming unit direction
    smooth_normal: tuple        # sign-flipped shading normal
    sign_dir: torch.Tensor
    random_sphere: tuple
    roughness_brdf: torch.Tensor
    is_solid: torch.Tensor
    write_id_w: torch.Tensor
    pick: ReservoirPick


def bounce_carry_init(primary_parts, camera_pos, direction3, aux) -> BounceCarry:
    ps, pu, pv, ptri = primary_parts
    zero = torch.zeros_like(ps)
    one = torch.ones_like(ps)
    render_id, glass, original_rme_x, original_tpo_x, first_ray_length = aux
    ray_origin = tuple(camera_pos[c].expand(ps.shape) for c in range(3))
    return BounceCarry(
        alive=ptri != -1, tri=torch.clamp_min(ptri, 0), hs=ps, hu=pu, hv=pv,
        ray_origin=ray_origin, ray_dir=direction3, last_hit_point=ray_origin,
        importancy=(one, one, one), original_color=(one, one, one),
        dont_filter=torch.ones_like(ps, dtype=torch.bool),
        final_color=(zero, zero, zero), render_id=render_id, glass=glass,
        original_rme_x=original_rme_x, original_tpo_x=original_tpo_x,
        first_ray_length=first_ray_length)


def bounce_pre(carry: BounceCarry, i: int, mat, config):
    """Bounce stage 1 (glsl:475-526): importance kill, material row fetch,
    hit-point update, normal interpolation, texture coordinates.
    Returns (carry, BounceSurface)."""
    zero = torch.zeros_like(carry.hs)
    importance_len = v3.norm3(v3.mul3(carry.importancy, carry.original_color))
    # logical_and: the shade kernel's drop-in keeps alive as a float row
    alive = torch.logical_and(carry.alive, importance_len >= config.min_importancy * SQRT3)
    m = alive
    rowt = fetch_rows_t(mat, carry.tri)      # [49, N]
    rot = tuple(rowt[40 + k] for k in range(9))

    new_origin = v3.add3(v3.scale3(carry.ray_dir, carry.hs), carry.ray_origin)
    ray_origin = v3.where3(m, new_origin, carry.ray_origin)
    uvw = (1.0 - carry.hu - carry.hv, carry.hu, carry.hv)

    wv = [(rowt[3 * k], rowt[3 * k + 1], rowt[3 * k + 2]) for k in range(3)]
    geometry_normal = v3.normalize3(v3.cross3(
        v3.sub3(wv[0], wv[1]), v3.sub3(wv[0], wv[2])))

    smooth_normal = (zero, zero, zero)
    geometry_offset = zero
    bary_u = zero
    bary_v = zero
    for k in range(3):
        vn = (rowt[12 + 3 * k], rowt[13 + 3 * k], rowt[14 + 3 * k])
        wn = v3.matvec3(rot, vn)
        smooth_normal = v3.add3(smooth_normal, v3.scale3(wn, uvw[k]))
        # tan(acos(x)) = sqrt(1-x^2)/x: shadow-acne offset (glsl:516-518)
        cos_a = torch.abs(torch.clamp(v3.dot3(geometry_normal, wn), -1.0, 1.0))
        tan_a = torch.clamp(v3.sqrt(1.0 - cos_a * cos_a) / cos_a, 0.0, 1.0)
        diff = v3.norm3(v3.sub3(ray_origin, wv[k]))
        geometry_offset = geometry_offset + diff * tan_a * uvw[k]
        bary_u = bary_u + rowt[21 + 2 * k] * uvw[k]
        bary_v = bary_v + rowt[22 + 2 * k] * uvw[k]
    smooth_normal = v3.normalize3(smooth_normal)

    surface = BounceSurface(
        m=m, smooth_normal=smooth_normal, geometry_offset=geometry_offset,
        bary_u=bary_u, bary_v=bary_v,
        tex_nums=(rowt[27], rowt[28], rowt[29]),
        inline_albedo=(rowt[30], rowt[31], rowt[32]),
        inline_rme=(rowt[33], rowt[34], rowt[35]),
        inline_tpo=(rowt[36], rowt[37], rowt[38]))
    return carry._replace(alive=alive, ray_origin=ray_origin), surface


def bounce_tex(buffers: SceneBuffers, surface: BounceSurface):
    """Bounce stage 2: the three atlas fetches (glsl:502-510). Returns
    (albedo3, rough, metal, emis, tpo3)."""
    albedo = fetch_tex_val_table(buffers.albedo_tab, surface.bary_u,
                                 surface.bary_v, surface.tex_nums[0],
                                 surface.inline_albedo)
    rough, metal, emis = fetch_tex_val_table(
        buffers.pbr_tab, surface.bary_u, surface.bary_v, surface.tex_nums[1],
        surface.inline_rme)
    tpo = fetch_tex_val_table(buffers.tpo_tab, surface.bary_u, surface.bary_v,
                              surface.tex_nums[2], surface.inline_tpo)
    return albedo, rough, metal, emis, tpo


def bounce_shade(carry: BounceCarry, surface: BounceSurface, tex, i: int,
                 buffers: SceneBuffers, camera_pos, ndc2, cos_sample_n,
                 config, random_seed):
    """Bounce stage 3a (glsl:529-576 + reservoir selection 400-447):
    shading frame, Fresnel-chance decision, first-surface bookkeeping,
    reservoir light selection, up to the NEE shadow ray.
    Returns (carry, ShadeRequest)."""
    albedo, rough, metal, emis, tpo = tex
    m = surface.m
    smooth_normal = surface.smooth_normal
    zero = torch.zeros_like(carry.hs)
    ray_origin = carry.ray_origin
    last_hit_point = carry.last_hit_point
    dont_filter = carry.dont_filter
    rng_mode = config.rng

    ray_dir = v3.where3(m, v3.normalize3(v3.sub3(ray_origin, last_hit_point)),
                        carry.ray_dir)
    sign_dir = v3.sign(v3.dot3(ray_dir, smooth_normal))
    smooth_normal = v3.scale3(smooth_normal, -sign_dir)

    rv = noise4(ndc2[0], ndc2[1], f32(i, zero) + cos_sample_n, random_seed,
                mode=rng_mode)
    random_sphere = v3.normalize3(v3.add3(
        smooth_normal, v3.normalize3((rv[0], rv[1], rv[2]))))
    brdf = 1.0 + (torch.abs(v3.dot3(smooth_normal, ray_dir)) - 1.0) * metal
    roughness_brdf = rough * brdf
    rough_normal = v3.normalize3(v3.mix3(smooth_normal, random_sphere,
                                         roughness_brdf))

    h = v3.normalize3(v3.sub3(rough_normal, ray_dir))
    v_dot_h = torch.clamp_min(-v3.dot3(ray_dir, h), 0.0)
    one_m_theta5 = pow5(1.0 - v_dot_h)
    fresnel_reflect = zero
    for c in range(3):
        f0 = albedo[c] * brdf
        fresnel_reflect = torch.maximum(fresnel_reflect,
                                        f0 + (1.0 - f0) * one_m_theta5)
    # Fresnel-chance solid/translucent decision (glsl:550)
    is_solid = tpo[0] * fresnel_reflect <= torch.abs(rv[3])

    # first-surface bookkeeping vs importancy accumulation (glsl:553-573)
    df = dont_filter & m
    original_tpo_x = torch.where(df, tpo[0], carry.original_tpo_x)
    original_color = v3.where3(df, v3.mul3(carry.original_color, albedo),
                               carry.original_color)
    original_rme_x = torch.where(df, carry.original_rme_x + rough,
                                 carry.original_rme_x)
    idu = combine_normal_rme_soa(smooth_normal, rough, metal, emis)
    scale_i = 2.0 ** -i
    render_id = tuple(carry.render_id[c] + torch.where(df, scale_i * idu[c], 0.0)
                      for c in range(3)) + (carry.render_id[3],)
    new_dont_filter = ((rough < 0.01) & is_solid) | ~is_solid
    is_glass = is_solid & (tpo[0] > 0.01)
    glass = torch.where(df & is_glass, carry.glass + 1.0, carry.glass)
    new_dont_filter = new_dont_filter & ~is_glass
    importancy = v3.where3(~dont_filter & m, v3.mul3(carry.importancy, albedo),
                           carry.importancy)
    dont_filter = (df & new_dont_filter) | (~df & dont_filter)

    first_ray_length = carry.first_ray_length
    if i == 1:
        cam3 = tuple(camera_pos[c].expand(zero.shape) for c in range(3))
        ratio = (v3.norm3(v3.sub3(ray_origin, last_hit_point))
                 / torch.clamp_min(v3.norm3(v3.sub3(last_hit_point, cam3)), 1e-30))
        first_ray_length = torch.where(
            m, torch.minimum(ratio, first_ray_length), first_ray_length)

    pick = reservoir_select(
        buffers, albedo, rough, metal, emis, ray_origin, ray_dir, rv,
        v3.scale3(rough_normal, -sign_dir), v3.scale3(smooth_normal, -sign_dir),
        surface.geometry_offset, random_seed, rng_mode=rng_mode)
    write_id_w = (dont_filter | (i == 0)) & m

    carry = carry._replace(
        importancy=importancy, original_color=original_color,
        dont_filter=dont_filter, glass=glass, original_rme_x=original_rme_x,
        original_tpo_x=original_tpo_x, first_ray_length=first_ray_length,
        render_id=render_id)
    return carry, ShadeRequest(
        m=m, ray_dir=ray_dir, smooth_normal=smooth_normal, sign_dir=sign_dir,
        random_sphere=random_sphere, roughness_brdf=roughness_brdf,
        is_solid=is_solid, write_id_w=write_id_w, pick=pick)


def next_ray_dir(req: ShadeRequest, tpo):
    """The next bounce direction (glsl:582-589): reflect, or Fresnel-chance
    refract, roughness-mixed. Unmasked."""
    ray_dir = req.ray_dir
    smooth_normal = req.smooth_normal
    zero = torch.zeros_like(ray_dir[0])
    n_dot_i = v3.dot3(smooth_normal, ray_dir)
    reflected = v3.sub3(ray_dir, v3.scale3(smooth_normal, 2.0 * n_dot_i))
    inv_eta = 1.0 / tpo[2]
    eta = inv_eta + (tpo[2] - inv_eta) * v3.clamp_min0(req.sign_dir)
    k = 1.0 - eta * eta * (1.0 - n_dot_i * n_dot_i)
    refr_coef = eta * n_dot_i + v3.sqrt(torch.clamp_min(k, 0.0))
    refracted = v3.where3(
        k < 0.0, (zero, zero, zero),
        v3.sub3(v3.scale3(ray_dir, eta), v3.scale3(smooth_normal, refr_coef)))
    bounce_base = v3.where3(req.is_solid, reflected, refracted)
    return v3.normalize3(v3.mix3(bounce_base, req.random_sphere, req.roughness_brdf))


def bounce_apply(carry: BounceCarry, tex, req: ShadeRequest, shadowed) -> BounceCarry:
    """Bounce stage 3b (glsl:448-461 + 577-589): apply the NEE shadow
    result, accumulate radiance, compute the next ray direction."""
    tpo = tex[4]
    emis = tex[3]
    m = req.m
    local_color, id_w = reservoir_finish(req.pick, emis, shadowed)
    render_id = carry.render_id[0:3] + (
        torch.where(req.write_id_w, id_w, carry.render_id[3]),)
    final_color = v3.where3(
        m, v3.add3(carry.final_color, v3.mul3(local_color, carry.importancy)),
        carry.final_color)
    ray_dir = v3.where3(m, next_ray_dir(req, tpo), req.ray_dir)
    return carry._replace(render_id=render_id, final_color=final_color,
                          ray_dir=ray_dir)


def bounce_commit(carry: BounceCarry, m, i: int, config, traverse_soa) -> BounceCarry:
    """Bounce stage 3c (glsl:591-597): the next closest hit, a bounce cast
    (`bounce=True`: the sparse scheme sorts its wavefront)."""
    if i + 1 >= config.max_reflections:
        return carry
    zero = torch.zeros_like(carry.hs)
    one = torch.ones_like(carry.hs)
    ns, nu, nv, ntri = traverse_soa(
        v3.where3(m, carry.ray_origin, (zero, zero, zero)),
        v3.where3(m, carry.ray_dir, (zero, zero, one)), alive=m, bounce=True)
    hs = torch.where(m, ns, carry.hs)
    hu = torch.where(m, nu, carry.hu)
    hv = torch.where(m, nv, carry.hv)
    new_tri = torch.where(m, ntri, -1)
    alive = carry.alive & (new_tri != -1)
    tri = torch.clamp_min(torch.where(m, new_tri, carry.tri), 0)
    last_hit_point = v3.where3(m, carry.ray_origin, carry.last_hit_point)
    return carry._replace(alive=alive, tri=tri, hs=hs, hu=hu, hv=hv,
                          last_hit_point=last_hit_point)


def bounce_post(carry: BounceCarry, surface: BounceSurface, tex, i: int,
                buffers: SceneBuffers, camera_pos, ndc2, cos_sample_n, config,
                random_seed, traverse_soa, shadow_soa) -> BounceCarry:
    """Bounce stage 3 (glsl:529-599): bounce_shade -> NEE shadow ray ->
    bounce_apply -> bounce_commit."""
    carry, req = bounce_shade(carry, surface, tex, i, buffers, camera_pos,
                              ndc2, cos_sample_n, config, random_seed)
    shadowed = shadow_soa(req.pick.offset_target, req.pick.light_dir,
                          req.pick.max_len, alive=req.m, bounce=True)
    carry = bounce_apply(carry, tex, req, shadowed)
    return bounce_commit(carry, req.m, i, config, traverse_soa)


def light_trace(buffers: SceneBuffers, mat, primary_parts, camera_pos,
                direction3, ndc2, cos_sample_n, config, random_seed,
                traverse_soa, shadow_soa, aux, bounce_post_impl=None,
                bounce_step_impl=None):
    """The bounce loop (glsl:464-599) with kill masks, SoA over [N].
    `aux` carries the shader's globals across samples (glsl:84-89).

    The hooks are flexlight_tpu's (ops/pathtrace.py:806-852), through
    which the shading kernels of ops.shade enter: `bounce_post_impl`
    (ops.shade.make_shade_bounce_post) takes bounce_post's place after
    the eager bounce_pre and bounce_tex, `bounce_step_impl(carry, i, mat,
    ndc2, cos_sample_n, random_seed, traverse_soa, shadow_soa)`
    (ops.shade.make_fused_bounce_step) the whole bounce. Traced, bounce i
    is the span fl.bounce {i, shade}, `shade` the route: "interp_shade"
    (the step hook), "shade" (the post hook) or "eager"."""
    post = bounce_post if bounce_post_impl is None else bounce_post_impl
    shade = ("interp_shade" if bounce_step_impl is not None
             else "eager" if bounce_post_impl is None else "shade")
    carry = bounce_carry_init(primary_parts, camera_pos, direction3, aux)
    for i in range(config.max_reflections):
        with span("fl.bounce", i=i, shade=shade):
            if bounce_step_impl is not None:
                carry = bounce_step_impl(carry, i, mat, ndc2, cos_sample_n, random_seed,
                                         traverse_soa, shadow_soa)
                continue
            carry, surface = bounce_pre(carry, i, mat, config)
            tex = bounce_tex(buffers, surface)
            carry = post(carry, surface, tex, i, buffers, camera_pos, ndc2, cos_sample_n,
                         config, random_seed, traverse_soa, shadow_soa)
    final_color = tuple(carry.final_color[c] + carry.importancy[c] * buffers.ambient[c]
                        for c in range(3))
    aux = (carry.render_id, carry.glass, carry.original_rme_x,
           carry.original_tpo_x, carry.first_ray_length)
    return final_color, carry.original_color, carry.original_tpo_x, aux


def _contiguous3(x3):
    return tuple(c.contiguous() for c in x3)


def _pick_block(rows: int, width: int):
    """The squarest pixel block of 1024 rays that tiles the image exactly
    (flexlight_tpu/ops/pathtrace.py:873-878), or None."""
    for bh, bw in ((32, 32), (16, 64), (8, 128)):
        if rows % bh == 0 and width % bw == 0:
            return bh, bw
    return None


def block_tile(x, rows: int, width: int, bh: int, bw: int):
    """Flat row-major pixels [N, ...] -> bh x bw block order: a ray tile of
    consecutive rays then covers a compact pixel block, a tight frustum."""
    lead = x.shape[1:]
    x = x.reshape(rows // bh, bh, width // bw, bw, *lead)
    return x.transpose(1, 2).reshape(rows * width, *lead)


def block_untile(x, rows: int, width: int, bh: int, bw: int):
    """The inverse of `block_tile`."""
    lead = x.shape[1:]
    x = x.reshape(rows // bh, width // bw, bh, bw, *lead)
    return x.transpose(1, 2).reshape(rows * width, *lead)


def _row_casts(scheme: str, buffers: SceneBuffers, world_geom, tile: int):
    """(closest(o, d, edge) -> Hit, any_hit(o, d, max_len) -> bool) of the
    casts that take rays as [N, 3] rows and report geometry slots."""
    if scheme in ("scan", "packet"):
        from . import traverse as trv

        if scheme == "scan":
            return partial(trv.traverse_scan, world_geom), partial(trv.shadow_scan, world_geom)
        return (partial(trv.traverse_coherent, world_geom, tile=tile),
                partial(trv.shadow_coherent, world_geom, tile=tile))
    if scheme == "mxu":
        from . import traverse_mxu as mxu

        w = mxu.build_tri_matrix(world_geom, buffers.id_buffer)
        return partial(mxu.traverse_mxu, w, buffers.id_buffer), partial(mxu.shadow_mxu, w)
    from . import traverse_clustered as tc

    clusters = tc.build_clusters(world_geom, buffers.id_buffer)
    return (partial(tc.traverse_clustered, clusters),
            partial(tc.shadow_clustered, clusters))


# from this many triangles on, "auto" takes the sparse worklist casts
# (flexlight_tpu/models/pathtracer.py:342, models/rasterizer.py:367)
SPARSE_MIN_TRIS = 4096
# the schemes of scheme_casts (the row casts take rays as [N, 3] rows) and
# the path tracer's fused ones (ops.fused)
ROW_SCHEMES = ("scan", "packet", "mxu", "clustered")
CAST_SCHEMES = ("kernel", "sparse") + ROW_SCHEMES
FUSED_SCHEMES = ("fused_split", "fused")


def resolve_scheme(scheme: str, buffers: SceneBuffers | None = None, fused: bool = False) -> str:
    """The scheme a frame runs. "auto" on a scene (`buffers`) is
    flexlight_tpu's rule on a chip, here on every device: "sparse" from
    SPARSE_MIN_TRIS triangles on, else "fused_split" where `fused` allows
    it (the path tracer) and the scene is within its caps, else "kernel".
    The other schemes run only when asked for (flexlight_tpu's CPU branch
    to mxu / clustered is left behind, ROADMAP.md)."""
    schemes = (FUSED_SCHEMES if fused else ()) + CAST_SCHEMES
    if scheme == "auto" and buffers is not None:
        if buffers.id_buffer.shape[0] >= SPARSE_MIN_TRIS:
            return "sparse"
        if fused:
            from .fused import fused_split_eligible

            if fused_split_eligible(buffers):
                return "fused_split"
        return "kernel"
    if scheme not in schemes:
        raise ValueError(f"unknown scheme {scheme!r}; not one of {schemes} (or a renderer's "
                         "'auto')")
    return scheme


def scheme_casts(scheme: str, buffers: SceneBuffers, world_geom, kernels, tile: int = 1024):
    """The scheme's cast closures (traverse_soa, shadow_soa). Both take
    `bounce=True` on the casts of the bounce loop; the sparse scheme sorts
    those wavefronts (its hinted casts) and reports drawable indices. The
    scan and packet casts (ops.traverse, packets of `tile` rays), the mxu
    casts (ops.traverse_mxu) and the clustered casts
    (ops.traverse_clustered) test dead rays too, as flexlight_tpu's do:
    the bounce loop masks their hits."""
    if scheme in ROW_SCHEMES:
        closest, any_hit = _row_casts(scheme, buffers, world_geom, tile)

        def traverse_soa(o3, d3, alive=None, edge=BIAS, bounce=False):
            hit = closest(torch.stack(o3, dim=-1), torch.stack(d3, dim=-1), edge=edge)
            return hit.suv[:, 0], hit.suv[:, 1], hit.suv[:, 2], hit.triangle

        def shadow_soa(o3, d3, max_len, alive=None, bounce=False):
            return any_hit(torch.stack(o3, dim=-1), torch.stack(d3, dim=-1), max_len)

        return traverse_soa, shadow_soa
    if scheme == "sparse":
        from . import intersect_sparse as isp

        scene = isp.build_tiled(world_geom, buffers.id_buffer)
        sort = scene.n_tiles >= isp.SORT_MIN_TILES

        def traverse_soa(o3, d3, alive=None, edge=BIAS, bounce=False):
            return isp.traverse_sparse_soa(scene, o3, d3, alive=alive, edge=edge,
                                           sort_rays=sort and bounce, kernels=kernels)

        def shadow_soa(o3, d3, max_len, alive=None, bounce=False):
            return isp.shadow_sparse_soa(scene, o3, d3, max_len, alive=alive,
                                         sort_rays=sort and bounce, kernels=kernels)

        return traverse_soa, shadow_soa
    from . import intersect_kernel

    kernels = intersect_kernel if kernels is None else kernels
    w4, ids = intersect_kernel.build_w4(world_geom, buffers.id_buffer)

    def traverse_soa(o3, d3, alive=None, edge=BIAS, bounce=False):
        max_len = torch.full_like(o3[0], POW32)
        if alive is not None:
            max_len = torch.where(alive, max_len, 0.0)
        return kernels.closest_hit(w4, ids, _contiguous3(o3), _contiguous3(d3),
                                   max_len, edge)

    def shadow_soa(o3, d3, max_len, alive=None, bounce=False):
        if alive is not None:
            max_len = torch.where(alive, max_len, 0.0)
        return kernels.any_hit(w4, _contiguous3(o3), _contiguous3(d3),
                               max_len.contiguous())

    return traverse_soa, shadow_soa


def render_mrt(buffers: SceneBuffers, width: int, height: int, camera_pos,
               view_matrix, config, random_seed, scheme: str = "kernel",
               kernels=None, shade_kernel: bool | None = None, tile: int = 1024,
               row0: int = 0, rows: int | None = None, sample_offset: int = 0,
               local_samples: int | None = None, with_raw_aux: bool = False):
    """Full primary + bounce render to the MRT contract (glsl:601-646).
    Returns flat [N = rows * W] per-pixel outputs.

    scheme="kernel": the bounce loop as plain tensor code around the dense
    closest-hit / any-hit kernels (`kernels.closest_hit`,
    `kernels.any_hit`; default the CUDA kernel wrappers of
    ops.intersect_kernel). scheme="sparse": the same loop around the
    worklist casts of ops.intersect_sparse (`kernels.sparse_flags`,
    `sparse_key`, `sparse_closest`, `sparse_any`; default
    ops.intersect_sparse_kernel's wrappers), with the per-triangle tables
    in drawable order (flexlight_tpu/ops/pathtrace.py:957-1069,
    1174-1197). scheme="fused_split": the per-bounce PRE / POST kernels of
    ops.fused (`kernels.sp_pre`, `kernels.sp_post`; default
    ops.fused_kernel's wrappers). scheme="fused": the whole frame in one
    kernel of ops.fused (`kernels.fused_frame`), on scenes within
    ops.fused.fused_eligible, identical to "fused_split". `kernels` may be
    any object with those attributes, such as kernels.PLAIN.
    scheme="scan" and "packet" (flexlight_tpu's default and its packet
    casts, plain XLA there) run the same loop around ops.traverse's
    plain casts, the packets `tile` consecutive rays (N a multiple of
    tile); scheme="mxu" and "clustered" (flexlight_tpu's CPU routes) around
    the plain casts of ops.traverse_mxu and ops.traverse_clustered. From
    BLOCK_TILE_MIN_TRIS triangles on, the sparse and clustered schemes
    cast in block-tiled ray order.

    The kernel and sparse schemes may shade each bounce in a kernel of
    ops.shade, routed as flexlight_tpu routes (ops/pathtrace.py:1320-1345):
    scenes whose three atlases are 1x1 take `kernels.interp_shade`
    (bounce_pre, texture select and bounce_shade), other scenes with <= 256
    lights `kernels.shade` (bounce_shade); default ops.shade_kernel's
    wrappers. `shade_kernel` picks the route (ops.shade.bounce_shading):
    None (the default) takes a kernel where the scene allows on a CUDA
    device and the eager loop elsewhere, True takes a kernel and raises
    where none serves or on another scheme, False the eager loop.

    `row0` / `rows` render a horizontal strip of the image (tile sharding,
    parallel.tile_sharding); `sample_offset` / `local_samples` a slice of
    the per-pixel sample loop (sample sharding): the slice's sample j takes
    the noise phase of global sample sample_offset + j, and the color is
    still scaled by 1 / config.samples_per_ray, so the slices' colors sum
    to the whole loop's. `with_raw_aux` also returns (original_rme_x,
    first_ray_length) before original_w folds them into
    min(rme, frl): rme sums over the samples and frl is their running
    min, so sample shards combine the raw channels first.

    Traced (kernel, sparse, scan, packet, mxu and clustered schemes): the
    camera rays and the primary cast are the span fl.primary, each bounce
    fl.bounce {i, shade} (light_trace), the render targets fl.mrt."""
    if scheme in FUSED_SCHEMES:
        if shade_kernel:
            raise ValueError(f"shade_kernel=True shades the bounces of scheme='kernel' and "
                             f"'sparse'; scheme={scheme!r} shades inside its own kernel")
        from . import fused

        render = fused.render_mrt_fused_split if scheme == "fused_split" else \
            fused.render_mrt_fused
        return render(buffers, width, height, camera_pos, view_matrix, config, random_seed,
                      kernels=kernels, row0=row0, rows=rows, sample_offset=sample_offset,
                      local_samples=local_samples, with_raw_aux=with_raw_aux)
    resolve_scheme(scheme)
    from . import shade

    route = shade.bounce_shading(buffers, scheme, shade_kernel, buffers.geometry.device.type)
    with span("fl.primary"):
        dev = buffers.geometry.device
        camera_pos = upload(camera_pos, dev)
        inv_view = upload(inverse_view(view_matrix), dev)
        random_seed = upload(random_seed, dev)
        world_geom = world_geometry(buffers)
        traverse_soa, shadow_soa = scheme_casts(scheme, buffers, world_geom, kernels, tile)

        n_rows = height if rows is None else rows
        origin3, direction3, ndc2 = camera_rays(width, height, camera_pos, inv_view, row0, n_rows)
        mat = build_material_table(buffers, world_geom)
        loc_geometry = buffers.geometry
        block = _pick_block(n_rows, width)
        blocked = (scheme in ("sparse", "clustered") and block is not None
                   and buffers.id_buffer.shape[0] >= BLOCK_TILE_MIN_TRIS)
        if blocked:
            # the origin is the camera for every ray: only directions and NDC move
            direction3 = tuple(block_tile(c, n_rows, width, *block) for c in direction3)
            ndc2 = tuple(block_tile(c, n_rows, width, *block) for c in ndc2)
        if scheme == "sparse":
            # the sparse casts report drawable indices: gather the per-triangle
            # tables into drawable order once per frame
            ids = buffers.id_buffer.long()
            mat = mat[ids]
            loc_geometry = loc_geometry[ids]
        # primaries replace the reference's watertight raster pass, so they take
        # the relaxed edge window; bounce rays keep the exact +BIAS window
        primary_parts = traverse_soa(origin3, direction3, edge=-BIAS)

    # the drop-ins made after the primary cast, from the uploaded camera: a
    # frame's peak before its bounces holds nothing of theirs
    bounce_post_impl = bounce_step_impl = None
    if route == "interp_shade":
        bounce_step_impl = shade.make_fused_bounce_step(buffers, camera_pos, config, kernels)
    elif route == "shade":
        bounce_post_impl = shade.make_shade_bounce_post(buffers, camera_pos, config, kernels)

    zero = torch.zeros_like(primary_parts[0])
    one = torch.ones_like(zero)
    aux = ((zero, zero, zero, zero),   # render_id
           zero, zero, zero,           # glassFilter, originalRMEx, originalTPOx
           one)                        # firstRayLength
    total = (zero, zero, zero)
    n_local = config.samples_per_ray if local_samples is None else local_samples
    for j in range(n_local):
        cos_sample_n = f32(sample_cos(sample_offset + j), zero)
        color, original_color, original_tpo_x, aux = light_trace(
            buffers, mat, primary_parts, camera_pos, direction3, ndc2,
            cos_sample_n, config, random_seed, traverse_soa, shadow_soa, aux,
            bounce_post_impl=bounce_post_impl, bounce_step_impl=bounce_step_impl)
        total = v3.add3(total, color)
    final_color = v3.scale3(total, 1.0 / config.samples_per_ray)
    with span("fl.mrt"):
        mrt = assemble_mrt(buffers, camera_pos, primary_parts[1:], final_color,
                           original_color, aux, loc_geometry=loc_geometry)
        raw = (aux[2], aux[4])    # originalRMEx, firstRayLength
        if blocked:
            mrt = MRT(*(block_untile(x, n_rows, width, *block) for x in mrt))
            raw = tuple(block_untile(x, n_rows, width, *block) for x in raw)
    return (mrt, raw) if with_raw_aux else mrt


def assemble_mrt(buffers: SceneBuffers, camera_pos, primary_uvt, final_color,
                 original_color, aux, loc_geometry=None) -> MRT:
    """The render targets of glsl:601-646 from the bounce loop's results:
    `primary_uvt` = (u, v, tri) of the primary hit (tri -1 on a miss),
    `final_color` averaged over the samples, `original_color` and `aux`
    (render_id 4-tuple, glass, originalRMEx, originalTPOx, firstRayLength)
    of the last sample. Uncovered pixels are zero. `loc_geometry` is the
    geometry table that `tri` indexes (default buffers.geometry)."""
    pu, pv, ptri = primary_uvt
    render_id, glass, original_rme_x, original_tpo_x, first_ray_length = aux
    covered = ptri != -1
    zero = torch.zeros_like(pu)
    dev = zero.device
    rid3 = render_id[3] + INV_255  # glsl:637

    # primary-hit local position for the location id channel (glsl:641-642)
    loc_geometry = buffers.geometry if loc_geometry is None else loc_geometry
    lrow = fetch_rows_t(loc_geometry, torch.clamp_min(ptri, 0))
    puvw = (1.0 - pu - pv, pu, pv)
    rel_pos = (zero, zero, zero)
    for k in range(3):
        lv = (lrow[3 * k], lrow[3 * k + 1], lrow[3 * k + 2])
        rel_pos = v3.add3(rel_pos, v3.scale3(lv, puvw[k]))
    cam3 = tuple(camera_pos[c].expand(zero.shape) for c in range(3))
    div = torch.clamp_min(2.0 * v3.norm3(v3.sub3(rel_pos, cam3)), 1e-30)
    loc3 = tuple(torch.remainder(rel_pos[c], div) / div for c in range(3))

    n = zero.shape[0]
    cov = covered
    covf = cov[:, None]
    zero3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    zero4 = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    render_id4 = torch.stack([render_id[0], render_id[1], render_id[2], rid3], dim=-1)
    location_id4 = torch.stack(
        [loc3[0], loc3[1], loc3[2], torch.full_like(zero, INV_255)], dim=-1)
    return MRT(
        color=torch.where(covf, v3.stack3(final_color), zero3),
        glass=torch.where(cov, glass, 0.0),
        original_color=torch.where(covf, v3.stack3(original_color), zero3),
        original_w=torch.where(
            cov, torch.minimum(original_rme_x, first_ray_length) + INV_255, 0.0),
        render_id=torch.where(covf, render_id4, zero4),
        original_id_w=torch.where(cov, original_tpo_x + INV_255, 0.0),
        location_id=torch.where(covf, location_id4, zero4),
        alpha=cov.to(torch.float32),
    )
