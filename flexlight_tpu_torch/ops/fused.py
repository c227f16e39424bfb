"""The fused schemes of small scenes (flexlight_tpu/ops/fused.py):
scheme="fused_split" (:513-1341), kernels 4 and 5 of the port, and
scheme="fused" (:104-466), kernel 10.

One fused_split frame sample is

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

scheme="fused" runs the same frame, every sample and bounce and the
atlas fetches, in ONE kernel launch (fused_frame) that keeps each ray's
state in registers and writes only the [FR_C, N] block the MRT needs.
Its plain version, `fused_frame_plain`, is the fused_split frame with the
plain versions of PRE and POST (`split_frame`), so the two schemes agree
bit for bit. Like flexlight_tpu it serves only scenes within
`fused_eligible`'s caps, and the auto rule never picks it.

`sp_pre_plain` / `sp_post_plain` are the kernels' plain versions, built
from the stage functions of ops.pathtrace; both update the state in
place, as the kernels do (each ray reads and writes only its own column).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.timing import span
from . import vec3 as v3
from .buffers import AtlasTable, SceneBuffers
from .geometry import world_geometry
from .intersect import BIAS, POW32
from .intersect_kernel import any_hit_plain, build_w4, closest_hit_plain
from .pathtrace import (BounceCarry, BounceSurface, assemble_mrt, bounce_apply,
                        bounce_carry_init, bounce_commit, bounce_pre, bounce_shade,
                        bounce_tex, build_material_table, camera_rays, inverse_view,
                        sample_cos, upload)
from .rng import f32

MAX_TRIS = 1024    # flexlight_tpu/ops/fused.py:72, the fused schemes' cap
MAX_LIGHTS = 256   # flexlight_tpu/ops/fused.py:89
MAX_TEXELS = 4096  # flexlight_tpu/ops/fused.py:73, scheme="fused"'s atlas cap

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
# The frame block (split_frame, the fused_frame kernel): final color (3),
# original color (3), render_id (4), glass, originalRMEx, originalTPOx,
# firstRayLength, the primary hit (s, u, v, triangle slot or -1)
FR_COLOR, FR_ORIGINAL_COLOR, FR_RENDER_ID = 0, 3, 6
FR_GLASS, FR_RME_X, FR_TPO_X, FR_FIRST_RAY_LENGTH = 10, 11, 12, 13
FR_PPART = 14
FR_C = 18


class _Lights(NamedTuple):
    """The part of SceneBuffers that the reservoir reads."""
    lights: torch.Tensor


class _Atlases(NamedTuple):
    """The part of SceneBuffers that bounce_tex reads."""
    albedo_tab: AtlasTable
    pbr_tab: AtlasTable
    tpo_tab: AtlasTable


def fused_split_eligible(buffers: SceneBuffers) -> bool:
    """Triangle and light counts within the split pipeline's caps
    (flexlight_tpu/ops/fused.py:516-521); atlases of any size."""
    return (buffers.id_buffer.shape[0] <= MAX_TRIS
            and buffers.lights.shape[0] <= MAX_LIGHTS)


def fused_eligible(buffers: SceneBuffers) -> bool:
    """flexlight_tpu's rule for scheme="fused" (ops/fused.py:104-109):
    <= 1024 triangles, <= 256 lights, and every atlas of <= 4096
    texels."""
    atlases = (buffers.albedo_atlas, buffers.pbr_atlas, buffers.tpo_atlas)
    return (buffers.id_buffer.shape[0] <= MAX_TRIS
            and buffers.lights.shape[0] <= MAX_LIGHTS
            and all(a.shape[0] * a.shape[1] <= MAX_TEXELS for a in atlases))


def carry_views(st: torch.Tensor) -> BounceCarry:
    """The carry as views of the state block's rows, alive, tri and
    dont_filter as their float rows (0 / 1, a triangle index)."""
    r3 = lambda k: (st[k], st[k + 1], st[k + 2])  # noqa: E731
    return BounceCarry(
        alive=st[ALIVE], tri=st[TRI], hs=st[HS], hu=st[HU], hv=st[HV],
        ray_origin=r3(RAY_ORIGIN), ray_dir=r3(RAY_DIR), last_hit_point=r3(LAST_HIT),
        importancy=r3(IMPORTANCY), original_color=r3(ORIGINAL_COLOR),
        dont_filter=st[DONT_FILTER], final_color=r3(FINAL_COLOR),
        render_id=tuple(st[RENDER_ID + k] for k in range(4)),
        glass=st[GLASS], original_rme_x=st[RME_X], original_tpo_x=st[TPO_X],
        first_ray_length=st[FIRST_RAY_LENGTH])


def carry_from_state(st: torch.Tensor) -> BounceCarry:
    c = carry_views(st)
    return c._replace(alive=c.alive > 0.0, tri=c.tri.to(torch.int32),
                      dont_filter=c.dont_filter > 0.0)


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


def record_from_w4(w4):
    """[T, 16] f32: the triangle records that POST and FRAME build from W
    [4, T, 16] (csrc/trace.cuh fl_rec_stage): n, v0.n, e2 x v0, v0 x e1, e2,
    e1, each one of W's entries or its exact negation, so the records are
    ops.intersect_sparse.tri_record's."""
    _, u, v, s = w4
    return torch.stack([s[:, 1], s[:, 2], s[:, 3], -s[:, 0], -u[:, 4], -u[:, 5], -u[:, 6],
                        -v[:, 4], -v[:, 5], -v[:, 6], u[:, 14], u[:, 9], u[:, 10], v[:, 12],
                        v[:, 13], v[:, 8]], dim=-1)


def live_list_plain(state):
    """The live-ray list kernel's plain version (part of kernel 5: POST
    walks the list): (list [N] int32, count [1] int32), the indices of the
    rays with m = 1 in ascending order, then -1. The kernel writes the same
    indices in any order of its warps' runs and leaves the entries past the
    count unset."""
    n = state.shape[1]
    idx = (state[SURF] > 0.0).nonzero().flatten().to(torch.int32)
    out = torch.full((n,), -1, dtype=torch.int32, device=state.device)
    out[:idx.shape[0]] = idx
    return out, torch.tensor([idx.shape[0]], dtype=torch.int32, device=state.device)


def split_frame(dirs, ndc, w4, ids, mat, lights, ambient, atlases, cam, seed, cos_samples,
                config, pre, post):
    """The samples of one frame through `pre`, bounce_tex and `post`
    around one state block, the ambient epilogue and the sample sum
    (light_trace's order): the [FR_C, N] frame block. `atlases` has the
    three AtlasTables; the frame runs one sample for each phase of
    `cos_samples` (the whole loop, or a slice of it: render_mrt's
    sample_offset / local_samples), and scales their sum by
    1 / config.samples_per_ray. Traced, each sample's `pre` is the span
    fl.primary, bounce i fl.bounce {i}."""
    n = dirs.shape[1]
    state = torch.empty((SP_C, n), dtype=torch.float32, device=dirs.device)
    total = None
    for s in range(len(cos_samples)):
        with span("fl.primary"):
            state = pre(state, dirs, w4, ids, mat, cam, s > 0, config)
        for i in range(config.max_reflections):
            with span("fl.bounce", i=i):
                tex = tex_block(atlases, state)
                state = post(state, tex, ndc, w4, ids, mat, lights, cam, seed, cos_samples[s],
                             i, config)
        # light_trace's epilogue (glsl:595-597): ambient by importancy
        color = tuple(state[FINAL_COLOR + c] + state[IMPORTANCY + c] * ambient[c]
                      for c in range(3))
        total = color if total is None else v3.add3(total, color)
    final_color = v3.scale3(total, 1.0 / config.samples_per_ray)
    return torch.stack([*final_color, *state[ORIGINAL_COLOR:ORIGINAL_COLOR + 3],
                        *state[RENDER_ID:RENDER_ID + 4], state[GLASS], state[RME_X],
                        state[TPO_X], state[FIRST_RAY_LENGTH], *state[PPART:PPART + 4]])


def fused_frame_plain(dirs, ndc, w4, ids, mat, lights, ambient, albedo_tab, pbr_tab, tpo_tab,
                      cam, seed, cos_samples, config):
    """Kernel 10's plain version (flexlight_tpu/ops/fused.py:175): the
    frame block [FR_C, N] of the camera rays (origin `cam` [3], directions
    `dirs` [3, N], pixel NDC `ndc` [2, N]) over the scene's W / ids /
    material table, lights [L, 2, 3], ambient [3] and atlas tables, with
    the 0-d `seed` and the phases `cos_samples` [S] of the S samples it
    runs (S = spp, or a slice's count): the fused_split frame with PRE and
    POST's plain versions."""
    return split_frame(dirs, ndc, w4, ids, mat, lights, ambient,
                       _Atlases(albedo_tab, pbr_tab, tpo_tab), cam, seed, cos_samples, config,
                       sp_pre_plain, sp_post_plain)


def frame_inputs(buffers: SceneBuffers, width: int, height: int, camera_pos, view_matrix,
                 row0: int = 0, rows: int | None = None):
    """(cam, dirs [3, N], ndc [2, N], w4, ids, material table) of a frame,
    or of its strip of `rows` rows from `row0` (N = rows * W). Traced: the
    span fl.primary."""
    with span("fl.primary"):
        dev = buffers.geometry.device
        cam = upload(camera_pos, dev)
        inv_view = upload(inverse_view(view_matrix), dev)
        world_geom = world_geometry(buffers)
        w4, ids = build_w4(world_geom, buffers.id_buffer)
        mat = build_material_table(buffers, world_geom).contiguous()
        _, direction3, ndc2 = camera_rays(width, height, cam, inv_view, row0, rows)
        return cam, torch.stack(direction3), torch.stack(ndc2), w4, ids, mat


def _phases(config, sample_offset: int, local_samples: int | None) -> list:
    """The noise phases of the samples a frame (or its slice) runs."""
    n = config.samples_per_ray if local_samples is None else local_samples
    return [sample_cos(sample_offset + j) for j in range(n)]


def mrt_from_block(buffers: SceneBuffers, cam, block, with_raw_aux: bool = False):
    """The MRT of a frame block (assemble_mrt); with `with_raw_aux`,
    (MRT, (original_rme_x, first_ray_length)) as render_mrt returns it.
    Traced: the span fl.mrt."""
    with span("fl.mrt"):
        aux = (tuple(block[FR_RENDER_ID + k] for k in range(4)), block[FR_GLASS],
               block[FR_RME_X], block[FR_TPO_X], block[FR_FIRST_RAY_LENGTH])
        ptri = block[FR_PPART + 3].to(torch.int32)
        mrt = assemble_mrt(buffers, cam, (block[FR_PPART + 1], block[FR_PPART + 2], ptri),
                           tuple(block[FR_COLOR:FR_COLOR + 3]),
                           tuple(block[FR_ORIGINAL_COLOR:FR_ORIGINAL_COLOR + 3]), aux)
    if with_raw_aux:
        return mrt, (block[FR_RME_X], block[FR_FIRST_RAY_LENGTH])
    return mrt


def render_mrt_fused_split(buffers: SceneBuffers, width: int, height: int,
                           camera_pos, view_matrix, config, random_seed,
                           kernels=None, row0: int = 0, rows: int | None = None,
                           sample_offset: int = 0, local_samples: int | None = None,
                           with_raw_aux: bool = False):
    """ops.pathtrace.render_mrt(scheme="fused_split"): the same MRT as
    flexlight_tpu's render_mrt_fused_split, with render_mrt's strip and
    sample-slice arguments. `kernels` has `sp_pre` and `sp_post` (default:
    ops.fused_kernel's CUDA kernel wrappers)."""
    if not fused_split_eligible(buffers):
        raise ValueError(f"scene too large for scheme='fused_split' "
                         f"({buffers.id_buffer.shape[0]} triangles, "
                         f"{buffers.lights.shape[0]} lights)")
    if kernels is None:
        from . import fused_kernel as kernels

    cam, dirs, ndc, w4, ids, mat = frame_inputs(buffers, width, height, camera_pos,
                                                 view_matrix, row0, rows)
    block = split_frame(dirs, ndc, w4, ids, mat, buffers.lights.contiguous(), buffers.ambient,
                        buffers, cam, float(random_seed),
                        _phases(config, sample_offset, local_samples), config,
                        kernels.sp_pre, kernels.sp_post)
    return mrt_from_block(buffers, cam, block, with_raw_aux)


def render_mrt_fused(buffers: SceneBuffers, width: int, height: int, camera_pos,
                     view_matrix, config, random_seed, kernels=None, row0: int = 0,
                     rows: int | None = None, sample_offset: int = 0,
                     local_samples: int | None = None, with_raw_aux: bool = False):
    """ops.pathtrace.render_mrt(scheme="fused"): the whole frame (or its
    strip and sample slice) in one launch of `kernels.fused_frame`
    (default: ops.fused_kernel's CUDA kernel wrapper), the same MRT as
    scheme="fused_split". Raises on a scene outside `fused_eligible`."""
    if not fused_eligible(buffers):
        texels = [a.shape[0] * a.shape[1]
                  for a in (buffers.albedo_atlas, buffers.pbr_atlas, buffers.tpo_atlas)]
        raise ValueError(f"scene not eligible for scheme='fused': "
                         f"{buffers.id_buffer.shape[0]} triangles (<= {MAX_TRIS}), "
                         f"{buffers.lights.shape[0]} lights (<= {MAX_LIGHTS}), atlases of "
                         f"{texels} texels (<= {MAX_TEXELS} each)")
    if kernels is None:
        from . import fused_kernel as kernels

    cam, dirs, ndc, w4, ids, mat = frame_inputs(buffers, width, height, camera_pos,
                                                 view_matrix, row0, rows)
    dev = cam.device
    seed = upload(random_seed, dev)
    cos_samples = upload(_phases(config, sample_offset, local_samples), dev)
    block = kernels.fused_frame(dirs, ndc, w4, ids, mat, buffers.lights.contiguous(),
                                buffers.ambient, buffers.albedo_tab, buffers.pbr_tab,
                                buffers.tpo_tab, cam, seed, cos_samples, config)
    return mrt_from_block(buffers, cam, block, with_raw_aux)
