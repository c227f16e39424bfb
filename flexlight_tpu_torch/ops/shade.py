"""The per-bounce shading kernels of the kernel and sparse schemes
(flexlight_tpu/ops/fused.py:1344-1707): kernels 11 and 12 of the port.

A kernel- or sparse-scheme frame shades each bounce in one kernel launch
instead of hundreds of torch ops, with flexlight_tpu's routing
(`bounce_shading`: by default on a CUDA device, render_mrt's
`shade_kernel`):

    all three atlases 1x1 (fused_step_eligible)   interp_shade: bounce_pre
        from the ray's material row, the 1x1-atlas texture select and
        bounce_shade, in one kernel (`make_fused_bounce_step`)
    else, <= MAX_LIGHTS lights (shade_kernel_eligible)   torch runs
        bounce_pre and bounce_tex, the kernel bounce_shade
        (`make_shade_bounce_post`)

Both stop at the NEE request (ShadeRequest): the shadow cast, bounce_apply
and the next closest hit (bounce_commit) stay with the scheme's casts and
torch, as in flexlight_tpu (:1516-1520, :1701-1705).

The kernels work on two blocks, each allocated once per frame:
- the state, float32 [ST_C, N]: the carry rows of ops/fused.py (N_CARRY)
  and the surface rows SURF .. SURF + 4 (m, smooth normal, geometry
  offset). It holds the carry for the whole frame: the drop-in copies
  into it the rows of a carry that are not yet its rows (the first
  bounce's, from bounce_carry_init, and bounce_pre's alive and ray origin
  on the shade route), `_apply_commit` writes bounce_apply's and
  bounce_commit's results into its rows in place, and the carry the
  drop-in returns is views of them (alive, tri and dont_filter as float
  rows), so no second carry lives beside the blocks;
- the request, float32 [REQ_C, N] (shade) or [REQ_STEP_C, N]
  (interp_shade: the request, then emis and tpo for bounce_apply).
A dead ray's request columns keep what they held (the kernels write
nothing for it); the drop-ins mask what bounce_apply reads of them.

flexlight_tpu's kernels carry seven "record" channels out per bounce and
pack the render ids outside because arctan2 has no Mosaic lowering; here
the packing runs inside (atan2 exists on the card), so there are none.
Its 2-D [G, 1024] shading layout (`use2d`) and the FLEXLIGHT_SHADE_KERNEL
/ FLEXLIGHT_FORCE_2D knobs stay behind: the switch is an argument.

`shade_plain` / `interp_shade_plain` are the kernels' plain versions,
built from the stage functions of ops.pathtrace; both update the state
and the request in place, as the kernels do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import vec3 as v3
from .buffers import AtlasTable, SceneBuffers
from .fused import (ALIVE, DONT_FILTER, FINAL_COLOR, FIRST_RAY_LENGTH, GLASS, HS, HU, HV,
                    IMPORTANCY, LAST_HIT, MAX_LIGHTS, ORIGINAL_COLOR, RAY_DIR, RAY_ORIGIN,
                    RENDER_ID, RME_X, SURF, TEX_C, TPO_X, TRI, _Lights, carry_from_state,
                    carry_rows, carry_views)
from .pathtrace import (BounceCarry, BounceSurface, ReservoirPick, ShadeRequest, bounce_pre,
                        bounce_shade, bounce_tex, next_ray_dir, reservoir_finish)

# the state block: the carry, then m, the smooth normal and the geometry offset
ST_C = SURF + 5
# the carry rows that bounce_shade changes
SHADED_ROWS = (*range(IMPORTANCY, IMPORTANCY + 3), *range(ORIGINAL_COLOR, ORIGINAL_COLOR + 3),
               DONT_FILTER, RENDER_ID, RENDER_ID + 1, RENDER_ID + 2, GLASS, RME_X, TPO_X,
               FIRST_RAY_LENGTH)
# ... and those that bounce_pre changes too
STEP_ROWS = (ALIVE, *range(RAY_ORIGIN, RAY_ORIGIN + 3), *SHADED_ROWS)

# request rows (ShadeRequest, ReservoirPick)
Q_RAY_DIR, Q_SMOOTH_NORMAL, Q_SIGN_DIR, Q_RANDOM_SPHERE = 0, 3, 6, 7
Q_ROUGHNESS_BRDF, Q_IS_SOLID, Q_WRITE_ID_W, Q_LOCAL_COLOR = 10, 11, 12, 13
Q_RES_NUM, Q_SHOW_COLOR, Q_SHOW_SHADOW = 16, 17, 18
Q_OFFSET_TARGET, Q_LIGHT_DIR, Q_MAX_LEN = 19, 22, 25
REQ_C = 26
# interp_shade's: then emis and tpo (3)
Q_EMIS, Q_TPO = 26, 27
REQ_STEP_C = 30


def shade_kernel_eligible(buffers: SceneBuffers) -> bool:
    """The lights fit the kernels' shared memory (flexlight_tpu/ops/fused.py:1418)."""
    return buffers.lights.shape[0] <= MAX_LIGHTS


def fused_step_eligible(buffers: SceneBuffers) -> bool:
    """shade_kernel_eligible, and all three atlases are the 1x1 placeholder
    (flexlight_tpu/ops/fused.py:1540): bounce_tex is then a select."""
    atlases = (buffers.albedo_atlas, buffers.pbr_atlas, buffers.tpo_atlas)
    return (shade_kernel_eligible(buffers)
            and all(a.shape[0] * a.shape[1] == 1 for a in atlases))


SHADED_SCHEMES = ("kernel", "sparse")


def bounce_shading(buffers: SceneBuffers, scheme: str, shade_kernel: bool | None,
                   device_type: str) -> str:
    """How the bounces of a frame on a cast scheme (ops.pathtrace.CAST_SCHEMES)
    shade: "interp_shade" (fused_step_eligible), "shade"
    (shade_kernel_eligible) or "eager" (the stage functions as torch ops).
    shade_kernel=None follows the scene on the kernel and sparse schemes on
    a device of type "cuda", and is "eager" on a scene neither kernel takes,
    on another scheme and on the CPU, where the wrappers run their plain
    versions (the same torch ops, packed: nothing to gain); True takes a
    kernel and raises where none serves; False is "eager"."""
    if shade_kernel is None:
        if device_type != "cuda" or scheme not in SHADED_SCHEMES:
            return "eager"
    elif not shade_kernel:
        return "eager"
    elif scheme not in SHADED_SCHEMES:
        raise ValueError(f"shade_kernel=True shades the bounces of scheme='kernel' and "
                         f"'sparse', not of scheme={scheme!r}")
    if fused_step_eligible(buffers):
        return "interp_shade"
    if shade_kernel_eligible(buffers):
        return "shade"
    if shade_kernel is None:
        return "eager"
    raise ValueError(f"shade_kernel=True: the scene has {buffers.lights.shape[0]} lights, the "
                     f"shading kernels take <= {MAX_LIGHTS}")


def trivial_atlas(buffers: SceneBuffers) -> torch.Tensor:
    """The one texel of each 1x1 atlas (albedo, pbr, tpo) as [9] float32."""
    return torch.cat([a.reshape(3) for a in (buffers.albedo_atlas, buffers.pbr_atlas,
                                             buffers.tpo_atlas)]).to(torch.float32).contiguous()


class _Atlases(NamedTuple):
    """The part of SceneBuffers that bounce_tex reads: three 1x1 tables."""
    albedo_tab: AtlasTable
    pbr_tab: AtlasTable
    tpo_tab: AtlasTable


def _atlas_tables(atlas: torch.Tensor) -> _Atlases:
    dev = atlas.device
    info = torch.tensor([[0, 1, 1]], dtype=torch.int32, device=dev)
    meta = torch.ones(5, dtype=torch.int32, device=dev)
    return _Atlases(*(AtlasTable(atlas[3 * k:3 * k + 3].reshape(1, 3), info, meta)
                      for k in range(3)))


def _request_rows(q: ShadeRequest) -> list:
    f = lambda x: x.to(torch.float32)  # noqa: E731
    p = q.pick
    return [*q.ray_dir, *q.smooth_normal, q.sign_dir, *q.random_sphere, q.roughness_brdf,
            f(q.is_solid), f(q.write_id_w), *p.local_color, f(p.res_num), f(p.show_color),
            f(p.show_shadow), *p.offset_target, *p.light_dir, p.max_len]


def _store(state, rows, which):
    for k in which:
        state[k].copy_(rows[k])


def shade_plain(state, req, tex, ndc, lights, cam, random_seed, cos_sample_n, i: int, config):
    """Kernel 11's plain version (flexlight_tpu/ops/fused.py:1364):
    bounce_shade(i) of every ray of `state` [ST_C, N] given its textures
    `tex` [TEX_C, N] (bounce_tex), pixel NDC `ndc` [2, N], `lights`
    [L, 2, 3], the camera `cam` [3] and the 0-d tensors `random_seed` and
    `cos_sample_n`. Writes the carry rows bounce_shade changes into
    `state` and the live rays' request into `req` [REQ_C, N]; returns
    (state, req)."""
    carry = carry_from_state(state)
    m = state[SURF] > 0.0
    surface = BounceSurface(
        m=m, smooth_normal=(state[SURF + 1], state[SURF + 2], state[SURF + 3]),
        geometry_offset=state[SURF + 4], bary_u=None, bary_v=None, tex_nums=None,
        inline_albedo=None, inline_rme=None, inline_tpo=None)
    texv = ((tex[0], tex[1], tex[2]), tex[3], tex[4], tex[5], (tex[6], tex[7], tex[8]))
    carry, q = bounce_shade(carry, surface, texv, i, _Lights(lights), cam, (ndc[0], ndc[1]),
                            cos_sample_n, config, random_seed)
    _store(state, carry_rows(carry), SHADED_ROWS)
    req.copy_(torch.where(m, torch.stack(_request_rows(q)), req))
    return state, req


def interp_shade_plain(state, req, ndc, mat, atlas, lights, cam, random_seed, cos_sample_n,
                       i: int, config):
    """Kernel 12's plain version (flexlight_tpu/ops/fused.py:1546):
    bounce_pre(i) from the material table `mat` [S, 49] (rows indexed by
    the carry's tri), bounce_tex on the 1x1 atlases whose texels `atlas`
    [9] holds, and bounce_shade(i). Writes alive, ray_origin, the carry
    rows bounce_shade changes and m into `state` [ST_C, N], and the live
    rays' request, emis and tpo into `req` [REQ_STEP_C, N]; returns
    (state, req)."""
    carry, surface = bounce_pre(carry_from_state(state), i, mat, config)
    texv = bounce_tex(_atlas_tables(atlas), surface)
    carry, q = bounce_shade(carry, surface, texv, i, _Lights(lights), cam, (ndc[0], ndc[1]),
                            cos_sample_n, config, random_seed)
    _store(state, carry_rows(carry), STEP_ROWS)
    state[SURF].copy_(surface.m)
    emis, tpo = texv[3], texv[4]
    req.copy_(torch.where(surface.m, torch.stack(_request_rows(q) + [emis, *tpo]), req))
    return state, req


def alive_list_plain(state):
    """The alive-list kernel's plain version (part of kernel 12:
    interp_shade walks the list): m = 0 written for the rays of `state`
    [ST_C, N] that are not alive; (list [N] int32, count [1] int32), the
    indices of the alive rays in ascending order, then -1. The kernel
    writes the same indices in any order of its warps' runs and leaves the
    entries past the count unset."""
    n = state.shape[1]
    alive = state[ALIVE] > 0.0
    state[SURF].masked_fill_(~alive, 0.0)
    idx = alive.nonzero().flatten().to(torch.int32)
    out = torch.full((n,), -1, dtype=torch.int32, device=state.device)
    out[:idx.shape[0]] = idx
    return out, torch.tensor([idx.shape[0]], dtype=torch.int32, device=state.device)


def _carry_fields(c: BounceCarry) -> list:
    """The carry in state row order, unconverted (copy_ converts)."""
    return [c.alive, c.tri, c.hs, c.hu, c.hv, *c.ray_origin, *c.ray_dir, *c.last_hit_point,
            *c.importancy, *c.original_color, c.dont_filter, *c.final_color, *c.render_id,
            c.glass, c.original_rme_x, c.original_tpo_x, c.first_ray_length]


def _pack_rows(state, rows, first: int = 0):
    """Copy rows[k] into state[first + k] unless it already is that row."""
    for k, x in enumerate(rows):
        dst = state[first + k]
        if (x.data_ptr() == dst.data_ptr() and x.dtype == dst.dtype
                and x.stride() == dst.stride()):
            continue
        dst.copy_(x)


def _r3(block: torch.Tensor, k: int) -> tuple:
    return block[k], block[k + 1], block[k + 2]


def _request(rq: torch.Tensor, m: torch.Tensor) -> ShadeRequest:
    """The ShadeRequest of the request block. A dead ray's columns are
    stale; what `_apply_commit` reads of them is masked there (write_id_w
    here; render_id, final_color, ray_dir and the hit by m; the shadow
    cast by alive=m)."""
    return ShadeRequest(
        m=m, ray_dir=_r3(rq, Q_RAY_DIR), smooth_normal=_r3(rq, Q_SMOOTH_NORMAL),
        sign_dir=rq[Q_SIGN_DIR], random_sphere=_r3(rq, Q_RANDOM_SPHERE),
        roughness_brdf=rq[Q_ROUGHNESS_BRDF], is_solid=rq[Q_IS_SOLID] > 0.0,
        write_id_w=(rq[Q_WRITE_ID_W] > 0.0) & m,
        pick=ReservoirPick(
            local_color=_r3(rq, Q_LOCAL_COLOR), res_num=rq[Q_RES_NUM].to(torch.int32),
            show_color=rq[Q_SHOW_COLOR] > 0.0, show_shadow=rq[Q_SHOW_SHADOW] > 0.0,
            offset_target=_r3(rq, Q_OFFSET_TARGET), light_dir=_r3(rq, Q_LIGHT_DIR),
            max_len=rq[Q_MAX_LEN]))


def _apply_commit(st: torch.Tensor, req: ShadeRequest, emis, tpo, shadowed, i: int, config,
                  traverse_soa) -> BounceCarry:
    """bounce_apply, then bounce_commit, on the carry that the state `st`
    holds: each value computed as they compute it, each result written
    into its row in place (`torch.where(..., out=)`). Returns the carry as
    views of the state (`carry_views`: bounce_pre takes alive and tri as
    float rows, and `_pack_rows` then finds every row in place)."""
    m = req.m

    def keep_or(mask, new, k):
        torch.where(mask, new, st[k], out=st[k])

    local_color, id_w = reservoir_finish(req.pick, emis, shadowed)
    keep_or(req.write_id_w, id_w, RENDER_ID + 3)
    ray_dir = next_ray_dir(req, tpo)
    for c in range(3):
        keep_or(m, st[FINAL_COLOR + c] + local_color[c] * st[IMPORTANCY + c], FINAL_COLOR + c)
        keep_or(m, ray_dir[c], RAY_DIR + c)
    if i + 1 < config.max_reflections:
        zero = torch.zeros_like(m, dtype=torch.float32)
        one = torch.ones_like(zero)
        hit = traverse_soa(v3.where3(m, _r3(st, RAY_ORIGIN), (zero, zero, zero)),
                           v3.where3(m, _r3(st, RAY_DIR), (zero, zero, one)), alive=m,
                           bounce=True)
        for k, x in zip((HS, HU, HV), hit[:3]):
            keep_or(m, x, k)
        new_tri = torch.where(m, hit[3], -1)
        # st[ALIVE] is 0 or 1: bounce_commit's alive & (new_tri != -1)
        torch.where(new_tri != -1, st[ALIVE], zero, out=st[ALIVE])
        keep_or(m, torch.clamp_min(new_tri, 0), TRI)
        for c in range(3):
            keep_or(m, st[RAY_ORIGIN + c], LAST_HIT + c)
    return carry_views(st)


class _FrameBlocks:
    """The blocks of one frame, allocated at its first bounce: the state,
    the request (zero at first, so a dead ray's stale columns are finite),
    the pixel NDC and, for the shade kernel, the textures."""

    def __init__(self, req_rows: int, tex_rows: int = 0):
        self.rows = (req_rows, tex_rows)
        self.state = self.req = self.ndc = self.tex = None

    def get(self, ndc2):
        if self.state is None:
            n, dev = ndc2[0].shape[0], ndc2[0].device
            self.state = torch.zeros((ST_C, n), dtype=torch.float32, device=dev)
            self.req = torch.zeros((self.rows[0], n), dtype=torch.float32, device=dev)
            self.tex = torch.empty((self.rows[1], n), dtype=torch.float32, device=dev)
            self.ndc = torch.stack(ndc2)
        return self.state, self.req, self.ndc, self.tex


def _default_kernels(kernels):
    if kernels is None:
        from . import shade_kernel as kernels
    return kernels


def _camera(camera_pos, buffers: SceneBuffers) -> torch.Tensor:
    return torch.as_tensor(camera_pos, dtype=torch.float32,
                           device=buffers.geometry.device).contiguous()


def make_shade_bounce_post(buffers: SceneBuffers, camera_pos, config, kernels=None):
    """light_trace's `bounce_post_impl` for one frame: bounce_shade in the
    `kernels.shade` kernel (default ops.shade_kernel's wrapper), then the
    scheme's shadow cast, bounce_apply and bounce_commit."""
    if not shade_kernel_eligible(buffers):
        raise ValueError(f"the shade kernel takes <= {MAX_LIGHTS} lights, the scene has "
                         f"{buffers.lights.shape[0]}")
    kernels = _default_kernels(kernels)
    cam = _camera(camera_pos, buffers)
    lights = buffers.lights.contiguous()
    blocks = _FrameBlocks(REQ_C, TEX_C)

    def bounce_post_fn(carry, surface, tex, i, buffers_, camera_pos_, ndc2, cos_sample_n,
                       config_, random_seed, traverse_soa, shadow_soa) -> BounceCarry:
        state, rq, ndc, texb = blocks.get(ndc2)
        _pack_rows(state, _carry_fields(carry))
        _pack_rows(state, [surface.m, *surface.smooth_normal, surface.geometry_offset], SURF)
        albedo, rough, metal, emis, tpo = tex
        torch.stack([*albedo, rough, metal, emis, *tpo], out=texb)
        kernels.shade(state, rq, texb, ndc, lights, cam, random_seed, cos_sample_n, i, config)
        req = _request(rq, surface.m)
        shadowed = shadow_soa(req.pick.offset_target, req.pick.light_dir, req.pick.max_len,
                              alive=req.m, bounce=True)
        return _apply_commit(state, req, emis, tpo, shadowed, i, config, traverse_soa)

    return bounce_post_fn


def make_fused_bounce_step(buffers: SceneBuffers, camera_pos, config, kernels=None):
    """light_trace's `bounce_step_impl` for one frame: bounce_pre, the
    texture select of the 1x1 atlases and bounce_shade in the
    `kernels.interp_shade` kernel (default ops.shade_kernel's wrapper),
    then the scheme's shadow cast, bounce_apply and bounce_commit. `mat`
    is the material table as render_mrt passes it (in drawable order on
    the sparse scheme)."""
    if not fused_step_eligible(buffers):
        raise ValueError("the interp_shade kernel takes 1x1 atlases and "
                         f"<= {MAX_LIGHTS} lights")
    kernels = _default_kernels(kernels)
    cam = _camera(camera_pos, buffers)
    lights = buffers.lights.contiguous()
    atlas = trivial_atlas(buffers)
    blocks = _FrameBlocks(REQ_STEP_C)

    def bounce_step_fn(carry, i, mat, ndc2, cos_sample_n, random_seed, traverse_soa,
                       shadow_soa) -> BounceCarry:
        state, rq, ndc, _ = blocks.get(ndc2)
        _pack_rows(state, _carry_fields(carry))
        kernels.interp_shade(state, rq, ndc, mat, atlas, lights, cam, random_seed,
                             cos_sample_n, i, config)
        req = _request(rq, state[SURF] > 0.0)
        shadowed = shadow_soa(req.pick.offset_target, req.pick.light_dir, req.pick.max_len,
                              alive=req.m, bounce=True)
        # bounce_apply reads emis and tpo of the textures
        return _apply_commit(state, req, rq[Q_EMIS], _r3(rq, Q_TPO), shadowed, i, config,
                             traverse_soa)

    return bounce_step_fn

