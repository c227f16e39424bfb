"""The denoise passes on packed rgba8 planes: kernel 2 of the port
(csrc/disc_filter.cu).

Every filter input is an rgba8-quantized image (k/255), so a pixel's four
channels pack losslessly into one int32 (b0 | b1<<8 | b2<<16 | b3<<24) and
the id-equality gates become integer compares
(flexlight_tpu/post/filter_kernel.py). The chain runs on packed [H, W]
int32 planes end to end; each pass hands the disc kernel the five planes
(ID, OID, COLOR, IP, OCOLOR) as they are, with no stack. The first pass's static-stencil vote
repair and the fast mode's blur-key tiling are torch ops here, as they
are XLA ops in flexlight_tpu.

The kernel wrappers `first_blur`, `second_blur` and `final_blur` run the
gather form of post/filters.py on CPU tensors (unpacked to floats and
packed back, which is lossless) and launch the CUDA kernel on CUDA
tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _native
from . import filters
from .common import quantize_rgba8, shifted

ID, OID, COLOR, IP, OCOLOR = range(5)
_XYZ = 0x00FFFFFF


def pack_rgba8(img: torch.Tensor) -> torch.Tensor:
    """[..., C<=4] f32 with values k/255 -> [...] int32, byte i = channel i."""
    b = torch.round(img * 255.0).to(torch.int64)
    out = b[..., 0]
    for i in range(1, img.shape[-1]):
        out = out | (b[..., i] << (8 * i))
    return _as_int32(out)


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding 32 bits -> int32 with the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def byte_i(x: torch.Tensor, i: int) -> torch.Tensor:
    return (x >> (8 * i)) & 0xFF


def byte_f(x: torch.Tensor, i: int) -> torch.Tensor:
    """Byte i as the exact quantized float k * f32(1/255)."""
    return byte_i(x, i).to(torch.float32) * (1.0 / 255.0)


def unpack_rgba8(x: torch.Tensor, channels: int = 4) -> torch.Tensor:
    """[...] int32 -> [..., channels] quantized floats."""
    return torch.stack([byte_f(x, i) for i in range(channels)], dim=-1)


def vote_repair_packed(ids_p: torch.Tensor, oid_p: torch.Tensor, ip_w: torch.Tensor):
    """filters.vote_repair on packed pixels: every id-equality test is one
    masked int32 compare. ids_p/oid_p [H, W] int32, ip_w [H, W] quantized
    f32. Returns (render_id_packed [H, W] int32, render_ip_w [H, W] f32)."""
    n_ids = [shifted(ids_p, dy, dx) for dy, dx in filters.STENCIL1]
    n_oids = [shifted(oid_p, dy, dx) for dy, dx in filters.STENCIL1]
    n_ipws = [shifted(ip_w, dy, dx) for dy, dx in filters.STENCIL1]
    xyz = lambda a: a & _XYZ
    votes = []
    for i in range(4):
        gate = n_ipws[i] == 0.0
        v = gate.to(torch.int32)
        match_center = (xyz(n_ids[i]) == xyz(ids_p)) & (n_oids[i] == oid_p)
        v = v + (gate & match_center).to(torch.int32)
        for j in range(i + 1, 4):
            pair = (xyz(n_ids[i]) == xyz(n_ids[j])) & (n_oids[i] == n_oids[j])
            v = v + (gate & pair).to(torch.int32)
        votes.append(v)
    max_vote = votes[0]
    voted_id = n_ids[0]
    for i in range(1, 4):
        better = votes[i] >= max_vote
        max_vote = torch.where(better, votes[i], max_vote)
        voted_id = torch.where(better, n_ids[i], voted_id)
    repair = (byte_i(oid_p, 3) != 0) & (ip_w != 0.0)
    render_id_p = torch.where(repair, voted_id, ids_p)
    render_ip_w = torch.where(repair, (max_vote == 0).to(torch.float32), ip_w)
    return render_id_p, render_ip_w


def blur_key_tile_sums(w: torch.Tensor, ty: int = 32, tx: int = 128, row0: int = 0):
    """(sums, counts), each [tile rows, tile columns] f32: the nonzero
    values of the blur-key plane w [H, W] and their number per (ty, tx)
    tile of the grid anchored at the image origin, w's first row being
    image row `row0` (a strip's tiles: its first and last may hold rows of
    other strips, counted here as zeros)."""
    top = row0 % ty
    h, wd = w.shape
    hp = -(-(top + h) // ty) * ty
    wp = -(-wd // tx) * tx
    t = F.pad(w, (0, wp - wd, top, hp - top - h)).reshape(hp // ty, ty, wp // tx, tx)
    nz = t > 0.0
    return torch.where(nz, t, 0.0).sum(dim=(1, 3)), nz.sum(dim=(1, 3)).to(torch.float32)


def apply_blur_key_means(ocolor_p: torch.Tensor, sums: torch.Tensor, counts: torch.Tensor,
                         ty: int = 32, tx: int = 128, row0: int = 0):
    """Byte 3 (the blur key) of each nonzero pixel of the packed plane
    becomes its tile's quantized nonzero mean (`blur_key_tile_sums`' grid
    of the same `row0`); bytes 0-2 untouched."""
    w = byte_f(ocolor_p, 3)
    h, wd = w.shape
    top = row0 % ty
    mean = torch.round(torch.clamp(sums / torch.clamp_min(counts, 1.0), 0.0, 1.0) * 255.0)
    tr, tc = mean.shape
    mean_full = mean.to(torch.int64)[:, None, :, None].expand(tr, ty, tc, tx)
    mean_full = mean_full.reshape(tr * ty, tc * tx)[top:top + h, :wd]
    new_b3 = torch.where(w > 0.0, mean_full, 0)
    return _as_int32((ocolor_p.to(torch.int64) & _XYZ) | (new_b3 << 24))


def tileize_blur_key_packed(ocolor_p: torch.Tensor, ty: int = 32, tx: int = 128):
    """common.tileize_blur_key on a packed plane: byte 3 (the blur key)
    becomes its per-tile nonzero mean; bytes 0-2 untouched."""
    sums, counts = blur_key_tile_sums(byte_f(ocolor_p, 3), ty, tx)
    return apply_blur_key_means(ocolor_p, sums, counts, ty, tx)


# --------------------------------------------------------------------------
# kernel 2: the disc passes on the five packed planes
# --------------------------------------------------------------------------

def _unpack5(ids, oid, color, ip, ocolor):
    """The five packed [H, W] planes -> (color, ip, ocolor, ids, oid)
    [H, W, 4] floats, the argument order of post/filters.py."""
    return tuple(unpack_rgba8(x) for x in (color, ip, ocolor, ids, oid))


def first_blur_plain(ids, oid, color, ip, ocolor):
    """(color_p, ip3_p): the first pass's disc blur, packed; byte 3 of
    ip3_p is zero (the vote repair fills it)."""
    new_color, new_ip3 = filters.first_blur(*_unpack5(ids, oid, color, ip, ocolor))
    return pack_rgba8(new_color), pack_rgba8(new_ip3)


def second_blur_plain(ids, oid, color, ip, ocolor):
    """(color_p, ip_p, ocolor_p) of the second pass."""
    return tuple(pack_rgba8(x)
                 for x in filters.second_filter(*_unpack5(ids, oid, color, ip, ocolor)))


def final_blur_plain(ids, oid, color, ip, ocolor, hdr: bool):
    """The display image [H, W, 3] f32 of the final pass."""
    return filters.final_filter(*_unpack5(ids, oid, color, ip, ocolor), hdr)


def _plane_ptrs(planes):
    """Check the five planes (ID, OID, COLOR, IP, OCOLOR: int32 [H, W], one
    shape and device, contiguous); (h, w, their pointers)."""
    if len(planes) != 5:
        raise ValueError(f"expected the 5 planes ID, OID, COLOR, IP, OCOLOR, got {len(planes)}")
    if planes[0].ndim != 2:
        raise ValueError(f"planes: expected [H, W], got {tuple(planes[0].shape)}")
    h, w = planes[0].shape
    for name, x in zip(("ids", "oid", "color", "ip", "ocolor"), planes):
        _native.require(x, name, torch.int32, (h, w), planes[0].device)
    return h, w, [_native.ptr(x) for x in planes]


def _first_blur_launch(lib, stream, *planes):
    h, w, ptrs = _plane_ptrs(planes)
    color = torch.empty((h, w), dtype=torch.int32, device=planes[0].device)
    ip3 = torch.empty_like(color)
    _native.check(lib.fl_disc_first(*ptrs, h, w, _native.ptr(color), _native.ptr(ip3), stream),
                  "first_blur")
    return color, ip3


def _second_blur_launch(lib, stream, *planes):
    h, w, ptrs = _plane_ptrs(planes)
    outs = tuple(torch.empty((h, w), dtype=torch.int32, device=planes[0].device)
                 for _ in range(3))
    _native.check(lib.fl_disc_second(*ptrs, h, w, *(_native.ptr(o) for o in outs), stream),
                  "second_blur")
    return outs


def _final_blur_launch(lib, stream, ids, oid, color, ip, ocolor, hdr: bool):
    h, w, ptrs = _plane_ptrs((ids, oid, color, ip, ocolor))
    out = torch.empty((h, w, 3), dtype=torch.float32, device=ids.device)
    _native.check(lib.fl_disc_final(*ptrs, h, w, int(bool(hdr)), _native.ptr(out), stream),
                  "final_blur")
    return out


first_blur = _native.Kernel("first_blur", first_blur_plain, _first_blur_launch)
second_blur = _native.Kernel("second_blur", second_blur_plain, _second_blur_launch)
final_blur = _native.Kernel("final_blur", final_blur_plain, _final_blur_launch)


# --------------------------------------------------------------------------
# the passes as the chain calls them
# --------------------------------------------------------------------------

def first_filter_packed(color_p, ip_p, ocolor_p, ids_p, oid_p, blur=first_blur):
    """First pass on packed [H, W] planes -> (color_p, ip_p, render_id_p)."""
    render_id_p, render_ip_w = vote_repair_packed(ids_p, oid_p, byte_f(ip_p, 3))
    color, ip3 = blur(ids_p, oid_p, color_p, ip_p, ocolor_p)
    # color.w is quantized (>= 0), so sign(w) == (w > 0)
    sgn = (byte_i(color_p, 3) > 0).to(torch.float32)
    ip_w = torch.round(quantize_rgba8(sgn * render_ip_w) * 255.0).to(torch.int64)
    return color, _as_int32(ip3.to(torch.int64) | (ip_w << 24)), render_id_p


def second_filter_packed(color_p, ip_p, ocolor_p, ids_p, oid_p, blur=second_blur):
    """Second pass -> (color_p, ip_p, ocolor_p)."""
    return blur(ids_p, oid_p, color_p, ip_p, ocolor_p)


def final_filter_packed(color_p, ip_p, ocolor_p, ids_p, oid_p, hdr: bool,
                        blur=final_blur):
    """Final pass -> the display image [H, W, 3] f32."""
    return blur(ids_p, oid_p, color_p, ip_p, ocolor_p, hdr)
