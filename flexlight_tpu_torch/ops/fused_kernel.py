"""The kernel wrappers of the fused schemes (csrc/fused.cu), behind their
plain versions in ops.fused: PRE and POST of scheme="fused_split",
kernels 4 and 5 of the port, and the whole-frame kernel of
scheme="fused", kernel 10. POST's launch first runs the live-ray list
kernel through its own wrapper (`sp_live_list`, part of kernel 5, which
counts its launches) and then POST over the list; the shade kernel
(ops.shade_kernel) walks the same list of its own state."""

from __future__ import annotations

import torch

from .. import _native
from .brdf import SQRT3
from .fused import (FR_C, MAX_TRIS, SP_C, TEX_C, fused_frame_plain, live_list_plain,
                    sp_post_plain, sp_pre_plain)
from .shade import ST_C

RNG_MODES = {"hash": 0, "counter": 1}


def _scene_args(state, w4, ids, mat, cam):
    dev = state.device
    n = state.shape[1]
    tp = w4.shape[1]
    _native.require(state, "state", torch.float32, (SP_C, n), dev)
    _native.require(w4, "w4", torch.float32, (4, tp, 16), dev)
    _native.require(ids, "ids", torch.int32, (tp,), dev)
    _native.require(mat, "mat", torch.float32, (mat.shape[0], 49), dev)
    _native.require(cam, "cam", torch.float32, (3,), dev)
    return n, tp


def _table_tris(tp: int) -> None:
    """PRE, POST and FRAME keep the whole record table in shared memory."""
    if tp > MAX_TRIS:
        raise ValueError(f"{tp} triangles: the fused kernels hold at most {MAX_TRIS}")


def _sp_pre_launch(lib, stream, state, dirs, w4, ids, mat, cam, resample: bool, config):
    n, tp = _scene_args(state, w4, ids, mat, cam)
    _table_tris(tp)
    _native.require(dirs, "dirs", torch.float32, (3, n), state.device)
    _native.check(lib.fl_sp_pre(
        _native.ptr(state), _native.ptr(dirs), _native.ptr(w4), tp, _native.ptr(ids),
        _native.ptr(mat), _native.ptr(cam), int(bool(resample)),
        config.min_importancy * SQRT3, n, stream), "sp_pre")
    return state


def _sp_live_list_launch(lib, stream, state):
    """(list [N] int32, count [1] int32): the indices of the state's rays
    with m = 1, in runs of ascending order (a warp's), and how many; the
    entries past the count are not written. `state` is POST's [SP_C, N]
    or the shade kernel's [ST_C, N]: both keep m in row SURF, the one row
    the kernel reads."""
    n = state.shape[1]
    rows = ST_C if state.shape[0] == ST_C else SP_C
    _native.require(state, "state", torch.float32, (rows, n), state.device)
    live = torch.empty(n, dtype=torch.int32, device=state.device)
    count = torch.empty(1, dtype=torch.int32, device=state.device)
    _native.check(lib.fl_sp_live_list(_native.ptr(state), n, _native.ptr(live),
                                      _native.ptr(count), stream), "sp_live_list")
    return live, count


def _sp_post_launch(lib, stream, state, tex, ndc, w4, ids, mat, lights, cam,
                    random_seed: float, cos_sample_n: float, i: int, config):
    n, tp = _scene_args(state, w4, ids, mat, cam)
    _table_tris(tp)
    dev = state.device
    _native.require(tex, "tex", torch.float32, (TEX_C, n), dev)
    _native.require(ndc, "ndc", torch.float32, (2, n), dev)
    n_lights = lights.shape[0]
    _native.require(lights, "lights", torch.float32, (n_lights, 2, 3), dev)
    if config.rng not in RNG_MODES:
        raise ValueError(f"unknown rng mode {config.rng!r}")
    live, count = sp_live_list.run(lib, stream, state)
    _native.check(lib.fl_sp_post(
        _native.ptr(state), _native.ptr(tex), _native.ptr(ndc), _native.ptr(w4), tp,
        _native.ptr(ids), _native.ptr(mat), _native.ptr(lights), n_lights,
        _native.ptr(cam), float(random_seed), float(cos_sample_n), int(i),
        int(i + 1 < config.max_reflections), RNG_MODES[config.rng],
        config.min_importancy * SQRT3, n, _native.ptr(live), _native.ptr(count), stream),
        "sp_post")
    return state


def table_args(tab, name: str, dev) -> list:
    """The C arguments of one AtlasTable: texels (u8 or f32), whether they
    are u8, tile_info, its slot count, meta."""
    texels, info, meta = tab
    if texels.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"{name}.texels: expected uint8 or float32, got {texels.dtype}")
    _native.require(texels, f"{name}.texels", texels.dtype, (texels.shape[0], 3), dev)
    _native.require(info, f"{name}.tile_info", torch.int32, (info.shape[0], 3), dev)
    _native.require(meta, f"{name}.meta", torch.int32, (5,), dev)
    return [_native.ptr(texels), int(texels.dtype == torch.uint8), _native.ptr(info),
            info.shape[0], _native.ptr(meta)]


def _fused_frame_launch(lib, stream, dirs, ndc, w4, ids, mat, lights, ambient, albedo_tab,
                        pbr_tab, tpo_tab, cam, seed, cos_samples, config, lane_stats=None):
    """`lane_stats`, an int32 [2] tensor on the device or None: the kernel
    adds its warps' lane-steps and the lane-steps that ran a bounce to it
    (csrc/fused.cu). The kernel runs one sample for each phase of
    `cos_samples` and scales their sum by 1 / config.samples_per_ray (a
    sample slice runs fewer than spp)."""
    dev = dirs.device
    n = dirs.shape[1]
    tp = w4.shape[1]
    spp = cos_samples.shape[0] if cos_samples.ndim == 1 else -1
    if spp < 1:
        raise ValueError(f"cos_samples: expected [S] with S >= 1, got {tuple(cos_samples.shape)}")
    _native.require(dirs, "dirs", torch.float32, (3, n), dev)
    _native.require(ndc, "ndc", torch.float32, (2, n), dev)
    _native.require(w4, "w4", torch.float32, (4, tp, 16), dev)
    _native.require(ids, "ids", torch.int32, (tp,), dev)
    _native.require(mat, "mat", torch.float32, (mat.shape[0], 49), dev)
    n_lights = lights.shape[0]
    _native.require(lights, "lights", torch.float32, (n_lights, 2, 3), dev)
    _native.require(ambient, "ambient", torch.float32, (3,), dev)
    _native.require(cam, "cam", torch.float32, (3,), dev)
    _native.require(seed, "seed", torch.float32, (), dev)
    _native.require(cos_samples, "cos_samples", torch.float32, (spp,), dev)
    _table_tris(tp)
    if lane_stats is not None:
        _native.require(lane_stats, "lane_stats", torch.int32, (2,), dev)
    if config.rng not in RNG_MODES:
        raise ValueError(f"unknown rng mode {config.rng!r}")
    tables = (table_args(albedo_tab, "albedo_tab", dev) + table_args(pbr_tab, "pbr_tab", dev)
              + table_args(tpo_tab, "tpo_tab", dev))
    out = torch.empty((FR_C, n), dtype=torch.float32, device=dev)
    ray_counter = torch.empty(1, dtype=torch.int32, device=dev)  # zeroed by the C entry point
    _native.check(lib.fl_fused_frame(
        _native.ptr(out), _native.ptr(dirs), _native.ptr(ndc), _native.ptr(w4), tp,
        _native.ptr(ids), _native.ptr(mat), _native.ptr(lights), n_lights,
        _native.ptr(ambient), *tables, _native.ptr(cam), _native.ptr(seed),
        _native.ptr(cos_samples), spp, 1.0 / config.samples_per_ray, config.max_reflections,
        RNG_MODES[config.rng], config.min_importancy * SQRT3, n, _native.ptr(ray_counter),
        None if lane_stats is None else _native.ptr(lane_stats), stream), "fused_frame")
    return out


sp_pre = _native.Kernel("sp_pre", sp_pre_plain, _sp_pre_launch)
sp_live_list = _native.Kernel("sp_live_list", live_list_plain, _sp_live_list_launch)
sp_post = _native.Kernel("sp_post", sp_post_plain, _sp_post_launch)
fused_frame = _native.Kernel("fused_frame", fused_frame_plain, _fused_frame_launch)
