"""The per-bounce split pipeline, scheme="fused_split"
(flexlight_tpu/ops/fused.py:513-1341): kernels 4 and 5 of the port.

One frame sample is

    PRE       primary closest hit (relaxed -BIAS edge) + bounce_carry_init
              + bounce_pre(0)                                  (sp_pre)
    repeat for i = 0 .. max_reflections - 1:
      torch   bounce_tex: the three atlas fetches over the texin rows
      POST    bounce_post(i) (shading, reservoir NEE + shadow any hit,
              radiance, next direction, next closest hit)
              + bounce_pre(i + 1)                              (sp_post)

around ONE state block: a float32 [SP_C, N] tensor, one contiguous row per
channel (the layout below), which the kernels read and write and the
torch glue reads row by row. flexlight_tpu's TPU block layout (bricks,
padding, subtiles, bf16 limbs, one-hot fetches) is MXU scheduling and is
not ported. Unlike the TPU kernels, the state keeps render_id: atan2
exists on the card, so the id packing runs inside POST and needs no
per-bounce records. After the last bounce POST skips the next closest
hit and bounce_pre, whose results no render target reads.

`sp_pre_plain` / `sp_post_plain` are the kernels' plain versions, built
from the stage functions of ops.pathtrace; both update the state in
place, as the kernels do (each ray reads and writes only its own column).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import vec3 as v3
from .buffers import SceneBuffers
from .geometry import world_geometry
from .intersect import BIAS, POW32
from .intersect_kernel import any_hit_plain, build_w4, closest_hit_plain
from .pathtrace import (BounceCarry, BounceSurface, assemble_mrt, bounce_apply,
                        bounce_carry_init, bounce_commit, bounce_pre, bounce_shade,
                        bounce_tex, build_material_table, camera_rays, inverse_view,
                        sample_cos)
from .rng import f32

MAX_TRIS = 1024    # flexlight_tpu/ops/fused.py:72, the split pipeline's cap
MAX_LIGHTS = 256   # flexlight_tpu/ops/fused.py:89

# State block rows. The carry (BounceCarry):
ALIVE, TRI, HS, HU, HV = 0, 1, 2, 3, 4
RAY_ORIGIN, RAY_DIR, LAST_HIT = 5, 8, 11            # 3 rows each
IMPORTANCY, ORIGINAL_COLOR = 14, 17                 # 3 rows each
DONT_FILTER = 20
FINAL_COLOR = 21                                    # 3 rows
RENDER_ID = 24                                      # 4 rows
GLASS, RME_X, TPO_X, FIRST_RAY_LENGTH = 28, 29, 30, 31
N_CARRY = 32
# the surface part of BounceSurface that POST reads: m, smooth normal (3),
# geometry offset
SURF = 32
# the primary hit (s, u, v, tri): read by the MRT assembly and by PRE when
# it resamples (spp > 1)
PPART = 37
# the texture request of the next bounce, read by bounce_tex: bary u, v,
# tex nums (3), inline albedo (3), rme (3), tpo (3)
TEXIN = 41
SP_C = 55
# bounce_tex -> POST: albedo (3), rough, metal, emis, tpo (3)
TEX_C = 9


class _Lights(NamedTuple):
    """The part of SceneBuffers that the reservoir reads."""
    lights: torch.Tensor


def fused_split_eligible(buffers: SceneBuffers) -> bool:
    """Triangle and light counts within the split pipeline's caps
    (flexlight_tpu/ops/fused.py:516-521); atlases of any size."""
    return (buffers.id_buffer.shape[0] <= MAX_TRIS
            and buffers.lights.shape[0] <= MAX_LIGHTS)


def carry_from_state(st: torch.Tensor) -> BounceCarry:
    r3 = lambda k: (st[k], st[k + 1], st[k + 2])  # noqa: E731
    return BounceCarry(
        alive=st[ALIVE] > 0.0, tri=st[TRI].to(torch.int32),
        hs=st[HS], hu=st[HU], hv=st[HV],
        ray_origin=r3(RAY_ORIGIN), ray_dir=r3(RAY_DIR), last_hit_point=r3(LAST_HIT),
        importancy=r3(IMPORTANCY), original_color=r3(ORIGINAL_COLOR),
        dont_filter=st[DONT_FILTER] > 0.0, final_color=r3(FINAL_COLOR),
        render_id=tuple(st[RENDER_ID + k] for k in range(4)),
        glass=st[GLASS], original_rme_x=st[RME_X], original_tpo_x=st[TPO_X],
        first_ray_length=st[FIRST_RAY_LENGTH])


def carry_rows(c: BounceCarry) -> list:
    f = lambda x: x.to(torch.float32)  # noqa: E731
    return [f(c.alive), f(c.tri), c.hs, c.hu, c.hv, *c.ray_origin, *c.ray_dir,
            *c.last_hit_point, *c.importancy, *c.original_color, f(c.dont_filter),
            *c.final_color, *c.render_id, c.glass, c.original_rme_x,
            c.original_tpo_x, c.first_ray_length]


def surface_rows(s: BounceSurface) -> list:
    return [s.m.to(torch.float32), *s.smooth_normal, s.geometry_offset]


def texin_rows(s: BounceSurface) -> list:
    return [s.bary_u, s.bary_v, *s.tex_nums, *s.inline_albedo, *s.inline_rme,
            *s.inline_tpo]


def texin_surface(st: torch.Tensor) -> BounceSurface:
    """The texin rows as the BounceSurface that bounce_tex reads."""
    r3 = lambda k: (st[k], st[k + 1], st[k + 2])  # noqa: E731
    return BounceSurface(
        m=None, smooth_normal=None, geometry_offset=None,
        bary_u=st[TEXIN], bary_v=st[TEXIN + 1], tex_nums=r3(TEXIN + 2),
        inline_albedo=r3(TEXIN + 5), inline_rme=r3(TEXIN + 8),
        inline_tpo=r3(TEXIN + 11))


def tex_block(buffers: SceneBuffers, state: torch.Tensor) -> torch.Tensor:
    """bounce_tex over the state's texin rows -> [TEX_C, N]."""
    albedo, rough, metal, emis, tpo = bounce_tex(buffers, texin_surface(state))
    return torch.stack([*albedo, rough, metal, emis, *tpo])


def sp_pre_plain(state, dirs, w4, ids, mat, cam, resample: bool, config):
    """Kernel 4's plain version (flexlight_tpu/ops/fused.py:872): the
    primary closest hit of the camera rays (origin `cam` [3], directions
    `dirs` [3, N]) with the relaxed -BIAS edge, bounce_carry_init and
    bounce_pre(0), written into `state` [SP_C, N]. With `resample` (the
    samples after the first) the primary hit and the carried render_id,
    glass, originalRMEx, originalTPOx and firstRayLength are read from
    `state` instead. Returns `state`."""
    n = dirs.shape[1]
    d3 = (dirs[0], dirs[1], dirs[2])
    if resample:
        ps, pu, pv = state[PPART], state[PPART + 1], state[PPART + 2]
        ptri = state[PPART + 3].to(torch.int32)
        aux = (tuple(state[RENDER_ID + k] for k in range(4)), state[GLASS],
               state[RME_X], state[TPO_X], state[FIRST_RAY_LENGTH])
    else:
        o3 = tuple(cam[c].expand(n) for c in range(3))
        max_len = torch.full((n,), POW32, dtype=torch.float32, device=dirs.device)
        ps, pu, pv, ptri = closest_hit_plain(w4, ids, o3, d3, max_len, -BIAS)
        zero = torch.zeros_like(ps)
        aux = ((zero, zero, zero, zero), zero, zero, zero, torch.ones_like(ps))
    carry = bounce_carry_init((ps, pu, pv, ptri), cam, d3, aux)
    carry, surface = bounce_pre(carry, 0, mat, config)
    rows = (carry_rows(carry) + surface_rows(surface)
            + [ps, pu, pv, ptri.to(torch.float32)] + texin_rows(surface))
    state.copy_(torch.stack(rows))
    return state


def sp_post_plain(state, tex, ndc, w4, ids, mat, lights, cam, random_seed: float,
                  cos_sample_n: float, i: int, config):
    """Kernel 5's plain version (flexlight_tpu/ops/fused.py:944): bounce
    `i` of every ray of `state` [SP_C, N] given its textures `tex`
    [TEX_C, N] and pixel NDC `ndc` [2, N]: bounce_shade, the shadow any
    hit, bounce_apply, and unless `i` is the last bounce the next closest
    hit (bounce_commit) and bounce_pre(i + 1). Updates `state` in place
    and returns it."""
    carry = carry_from_state(state)
    surface = BounceSurface(
        m=state[SURF] > 0.0, smooth_normal=(state[SURF + 1], state[SURF + 2], state[SURF + 3]),
        geometry_offset=state[SURF + 4], bary_u=None, bary_v=None, tex_nums=None,
        inline_albedo=None, inline_rme=None, inline_tpo=None)
    texv = ((tex[0], tex[1], tex[2]), tex[3], tex[4], tex[5], (tex[6], tex[7], tex[8]))
    zero = torch.zeros_like(carry.hs)
    carry, req = bounce_shade(carry, surface, texv, i, _Lights(lights), cam,
                              (ndc[0], ndc[1]), f32(cos_sample_n, zero), config,
                              f32(random_seed, zero))
    pick = req.pick
    shadowed = any_hit_plain(w4, pick.offset_target, pick.light_dir,
                             torch.where(req.m, pick.max_len, 0.0))
    carry = bounce_apply(carry, texv, req, shadowed)
    if i + 1 < config.max_reflections:
        def traverse_soa(o3, d3, alive, bounce=False):
            max_len = torch.where(alive, torch.full_like(o3[0], POW32), 0.0)
            return closest_hit_plain(w4, ids, o3, d3, max_len, BIAS)

        carry = bounce_commit(carry, req.m, i, config, traverse_soa)
        carry, s2 = bounce_pre(carry, i + 1, mat, config)
        rows = (carry_rows(carry) + surface_rows(s2)
                + [state[PPART + k] for k in range(4)] + texin_rows(s2))
    else:
        rows = carry_rows(carry) + [state[k] for k in range(SURF, SP_C)]
    state.copy_(torch.stack(rows))
    return state


def render_mrt_fused_split(buffers: SceneBuffers, width: int, height: int,
                           camera_pos, view_matrix, config, random_seed,
                           kernels=None):
    """ops.pathtrace.render_mrt(scheme="fused_split"): the same MRT as
    flexlight_tpu's render_mrt_fused_split. `kernels` has `sp_pre` and
    `sp_post` (default: ops.fused_kernel's CUDA kernel wrappers)."""
    if not fused_split_eligible(buffers):
        raise ValueError(f"scene too large for scheme='fused_split' "
                         f"({buffers.id_buffer.shape[0]} triangles, "
                         f"{buffers.lights.shape[0]} lights)")
    if kernels is None:
        from . import fused_kernel as kernels

    dev = buffers.geometry.device
    cam = torch.as_tensor(camera_pos, dtype=torch.float32, device=dev)
    inv_view = inverse_view(view_matrix).to(dev)
    seed = float(random_seed)
    world_geom = world_geometry(buffers)
    w4, ids = build_w4(world_geom, buffers.id_buffer)
    mat = build_material_table(buffers, world_geom).contiguous()
    _, direction3, ndc2 = camera_rays(width, height, cam, inv_view)
    dirs = torch.stack(direction3)
    ndc = torch.stack(ndc2)
    lights = buffers.lights.contiguous()
    n = dirs.shape[1]
    state = torch.empty((SP_C, n), dtype=torch.float32, device=dev)
    total = None
    for s in range(config.samples_per_ray):
        cos_sample_n = sample_cos(s)
        state = kernels.sp_pre(state, dirs, w4, ids, mat, cam, s > 0, config)
        for i in range(config.max_reflections):
            tex = tex_block(buffers, state)
            state = kernels.sp_post(state, tex, ndc, w4, ids, mat, lights, cam, seed,
                                    cos_sample_n, i, config)
        # light_trace's epilogue (glsl:595-597): ambient by importancy
        color = tuple(state[FINAL_COLOR + c] + state[IMPORTANCY + c] * buffers.ambient[c]
                      for c in range(3))
        total = color if total is None else v3.add3(total, color)
    final_color = v3.scale3(total, 1.0 / config.samples_per_ray)
    carry = carry_from_state(state)
    aux = (carry.render_id, carry.glass, carry.original_rme_x, carry.original_tpo_x,
           carry.first_ray_length)
    ptri = state[PPART + 3].to(torch.int32)
    return assemble_mrt(buffers, cam, (state[PPART + 1], state[PPART + 2], ptri),
                        final_color, carry.original_color, aux)
