"""Edge-aware denoise passes in gather form: the plain version of the disc
filter kernel (csrc/disc_filter.cu).

The reference's three filter shaders, arithmetic for arithmetic
(flexlight_tpu/post/filters.py; the id-equality gates decide parity):

- first_filter:  shadow-vote repair on the 4-neighbourhood + gated 37-tap
  disc blur of radius (1 + w)^2 * 3.5 (pathtracer_first_filter.glsl)
- second_filter: 36-tap disc blur of radius 1 + 2 tanh(ow + oidw * 4), with
  a separate original-colour sum for glass (pathtracer_second_filter.glsl)
- final_filter:  37-tap blur, first-hit albedo multiply, Reinhard + gamma
  (pathtracer_final_filter.glsl)

Images are [H, W, 4] rgba8-quantized floats. Each tap is one gather at
the per-pixel offset trunc(stencil[k] * scale), and the sums run tap by
tap from the accumulator the shaders (and the TPU kernel's `_*_init`)
start from, so this and the CUDA kernel take the same float operations
in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import INV_256, gather, quantize_rgba8, reinhard_gamma, shifted

# 4-neighbourhood (first_filter.glsl:36-40)
STENCIL1 = ((-1, 0), (0, -1), (0, 1), (1, 0))

# 37-tap disc (first_filter.glsl:50-58), (dy, dx)
STENCIL3 = np.array([
    [-3, -1], [-3, 0], [-3, 1],
    [-2, -2], [-2, -1], [-2, 0], [-2, 1], [-2, 2],
    [-1, -3], [-1, -2], [-1, -1], [-1, 0], [-1, 1], [-1, 2], [-1, 3],
    [0, -3], [0, -2], [0, -1], [0, 0], [0, 1], [0, 2], [0, 3],
    [1, -3], [1, -2], [1, -1], [1, 0], [1, 1], [1, 2], [1, 3],
    [2, -2], [2, -1], [2, 0], [2, 1], [2, 2],
    [3, -1], [3, 0], [3, 1],
], dtype=np.float32)

# 36-tap disc: STENCIL3 without the centre (second_filter.glsl:40-48)
STENCIL3_NO_CENTER = np.array([r for r in STENCIL3 if not (r[0] == 0 and r[1] == 0)],
                              dtype=np.float32)


def _taps(stencil: np.ndarray, scale: torch.Tensor):
    """Per tap, the offsets ivec2(stencil[k] * scale): truncation toward
    zero like GLSL float->int. Yields (dy, dx) [H, W] int64 pairs."""
    for sy, sx in stencil:
        yield (torch.trunc(float(sy) * scale).to(torch.int64),
               torch.trunc(float(sx) * scale).to(torch.int64))


def _all_eq(a, b):
    return (a == b).all(dim=-1)


def vote_repair(color, ip, ocolor, ids, oid):
    """Shadow-vote repair on the static 4-neighbourhood
    (first_filter.glsl:60-94) -> (render_id [H,W,4], render_ip_w [H,W])."""
    n_ids = [shifted(ids, dy, dx) for dy, dx in STENCIL1]
    n_oids = [shifted(oid, dy, dx) for dy, dx in STENCIL1]
    n_ipws = [shifted(ip[..., 3], dy, dx) for dy, dx in STENCIL1]
    votes = []
    for i in range(4):
        gate = n_ipws[i] == 0.0
        v = gate.to(torch.int32)
        match_center = _all_eq(n_ids[i][..., 0:3], ids[..., 0:3]) & _all_eq(n_oids[i], oid)
        v = v + (gate & match_center).to(torch.int32)
        for j in range(i + 1, 4):
            pair = (_all_eq(n_ids[i][..., 0:3], n_ids[j][..., 0:3])
                    & _all_eq(n_oids[i], n_oids[j]))
            v = v + (gate & pair).to(torch.int32)
        votes.append(v)
    max_vote = votes[0]
    voted_id = n_ids[0]
    for i in range(1, 4):
        better = votes[i] >= max_vote
        max_vote = torch.where(better, votes[i], max_vote)
        voted_id = torch.where(better[..., None], n_ids[i], voted_id)
    repair = (oid[..., 3] != 0.0) & (ip[..., 3] != 0.0)
    render_id = torch.where(repair[..., None], voted_id, ids)
    render_ip_w = torch.where(
        repair, torch.clamp_min(1.0 - torch.sign(max_vote.to(torch.float32)), 0.0),
        ip[..., 3])
    return render_id, render_ip_w


def first_blur(color, ip, ocolor, ids, oid):
    """The first pass's gated disc blur (first_filter.glsl:96-124) ->
    (new_color [H,W,4], new_ip rgb [H,W,3]), both quantized."""
    center_idw = torch.round(ids[..., 3] * 255.0).to(torch.int32)
    center_light = center_idw // 2
    center_shadow = center_idw % 2
    t = 1.0 + ocolor[..., 3]
    scale = t * t * 3.5
    acc = torch.zeros_like(color[..., 0:3])
    cnt = torch.zeros_like(scale)
    for dy, dx in _taps(STENCIL3, scale):
        b_id, b_oid, b_color, b_ip = (gather(x, dy, dx) for x in (ids, oid, color, ip))
        idw = torch.round(b_id[..., 3] * 255.0).to(torch.int32)
        gate = (_all_eq(b_id[..., 0:3], ids[..., 0:3]) & _all_eq(b_oid, oid)
                & ((center_light != idw // 2) | (center_shadow == idw % 2)))
        contrib = b_color[..., 0:3] + b_ip[..., 0:3] * 256.0
        acc = acc + torch.where(gate[..., None], contrib, 0.0)
        cnt = cnt + gate.to(torch.float32)
    no_blur = ocolor[..., 3] == 0.0
    out3 = torch.where(no_blur[..., None], color[..., 0:3], acc)
    count = torch.where(no_blur, 1.0, torch.clamp_min(cnt, 1.0))
    q = out3 * (1.0 / count)[..., None]
    sgn = torch.sign(color[..., 3:4])
    new_color = torch.cat([sgn * torch.remainder(q, 1.0), sgn * color[..., 3:4]], dim=-1)
    new_ip3 = sgn * (torch.floor(q) * INV_256)
    return quantize_rgba8(new_color), quantize_rgba8(new_ip3)


def first_filter(color, ip, ocolor, ids, oid):
    """(color, ip, id) <- shadow-vote repair + gated disc blur."""
    render_id, render_ip_w = vote_repair(color, ip, ocolor, ids, oid)
    new_color, new_ip3 = first_blur(color, ip, ocolor, ids, oid)
    ip_w = quantize_rgba8(torch.sign(color[..., 3]) * render_ip_w)
    return new_color, torch.cat([new_ip3, ip_w[..., None]], dim=-1), quantize_rgba8(render_id)


def second_filter(color, ip, ocolor, ids, oid):
    """(color, ip, ocolor) <- glass-aware disc blur (second_filter.glsl)."""
    acc = torch.cat([color[..., 0:3] + ip[..., 0:3] * 256.0, color[..., 3:4]], dim=-1)
    oacc = ocolor
    ipw = ip[..., 3]
    count = torch.ones_like(ipw)
    ocount = torch.ones_like(ipw)
    scale = 1.0 + 2.0 * torch.tanh(ocolor[..., 3] + oid[..., 3] * 4.0)
    for dy, dx in _taps(STENCIL3_NO_CENTER, scale):
        b_id, b_oid, b_color, b_ip, b_ocolor = (
            gather(x, dy, dx) for x in (ids, oid, color, ip, ocolor))
        oid_xyz = _all_eq(b_oid[..., 0:3], oid[..., 0:3])
        full_id = _all_eq(b_id, ids)
        id_xyz = _all_eq(b_id[..., 0:3], ids[..., 0:3])
        glassy = ((torch.minimum(oid[..., 3], b_oid[..., 3]) > 0.1)
                  & (full_id | (torch.maximum(b_ip[..., 3], ip[..., 3]) >= 0.1)))
        branch_a = oid_xyz & glassy
        add_color = branch_a | (oid_xyz & ~glassy & id_xyz)
        contrib = torch.cat([b_color[..., 0:3] + b_ip[..., 0:3] * 256.0,
                             b_color[..., 3:4]], dim=-1)
        acc = acc + torch.where(add_color[..., None], contrib, 0.0)
        count = count + add_color.to(torch.float32)
        ipw = ipw + torch.where(branch_a, b_ip[..., 3], 0.0)
        oacc = oacc + torch.where(branch_a[..., None], b_ocolor, 0.0)
        ocount = ocount + branch_a.to(torch.float32)
    q = acc * (1.0 / count)[..., None]
    cw = color[..., 3:4]
    new_color = cw * torch.cat([torch.remainder(q[..., 0:3], 1.0), q[..., 3:4]], dim=-1)
    new_ip = cw * torch.cat([torch.floor(q[..., 0:3]) * INV_256, ipw[..., None]], dim=-1)
    new_ocolor = cw * oacc / ocount[..., None]
    return quantize_rgba8(new_color), quantize_rgba8(new_ip), quantize_rgba8(new_ocolor)


def final_filter(color, ip, ocolor, ids, oid, hdr: bool):
    """Final blur + first-hit albedo multiply + tone map -> [H,W,3] in [0,1]."""
    scale = 0.7 + 2.0 * torch.tanh(ocolor[..., 3] + oid[..., 3] * 4.0)
    csum = torch.zeros_like(color[..., 0:3])
    osum = torch.zeros_like(color[..., 0:3])
    count = torch.zeros_like(scale)
    ocount = torch.zeros_like(scale)
    for dy, dx in _taps(STENCIL3, scale):
        b_id, b_oid, b_color, b_ip, b_ocolor = (
            gather(x, dy, dx) for x in (ids, oid, color, ip, ocolor))
        blur_tr = ((torch.maximum(b_ip[..., 3], ip[..., 3]) != 0.0)
                   & (torch.minimum(oid[..., 3], b_oid[..., 3]) > 0.0))
        oid_xyz = _all_eq(b_oid[..., 0:3], oid[..., 0:3])
        id_xyz = _all_eq(b_id[..., 0:3], ids[..., 0:3])
        o_gate = blur_tr & oid_xyz
        osum = osum + torch.where(o_gate[..., None], b_ocolor[..., 0:3], 0.0)
        ocount = ocount + o_gate.to(torch.float32)
        c_gate = (blur_tr | id_xyz) & oid_xyz
        # 255, not 256 (final_filter.glsl:51)
        contrib = b_color[..., 0:3] + b_ip[..., 0:3] * 255.0
        csum = csum + torch.where(c_gate[..., None], contrib, 0.0)
        count = count + c_gate.to(torch.float32)
    final = csum / torch.clamp_min(count, 1.0)[..., None]
    o_final = torch.where((ocount == 0.0)[..., None], ocolor[..., 0:3],
                          osum / torch.clamp_min(ocount, 1.0)[..., None])
    final = final * o_final
    if hdr:
        final = reinhard_gamma(final)
    covered = color[..., 3] > 0.0
    return torch.where(covered[..., None], torch.clamp(final, 0.0, 1.0), 0.0)
