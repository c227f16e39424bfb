"""The kernel wrappers of the shading kernels: shade and interp_shade
(csrc/shade.cu), kernels 11 and 12 of the port, behind their plain
versions in ops.shade. Each launch first writes the list of the rays it
shades, through the list kernel's own wrapper, which counts its launches:
shade the live-ray list of POST (ops.fused_kernel `sp_live_list`, the
rays with m = 1), interp_shade its alive list (`alive_list`, which also
writes m = 0 for the rays that are not alive); then the kernel walks the
list."""

from __future__ import annotations

import torch

from .. import _native
from .brdf import SQRT3
from .fused import TEX_C
from .fused_kernel import RNG_MODES, sp_live_list
from .shade import (REQ_C, REQ_STEP_C, ST_C, alive_list_plain, interp_shade_plain,
                    shade_plain)


def _common(state, req, req_rows, ndc, lights, cam, random_seed, cos_sample_n, config):
    """Check what both kernels take; (n, n_lights, rng mode)."""
    dev = state.device
    n = state.shape[1]
    _native.require(state, "state", torch.float32, (ST_C, n), dev)
    _native.require(req, "req", torch.float32, (req_rows, n), dev)
    _native.require(ndc, "ndc", torch.float32, (2, n), dev)
    n_lights = lights.shape[0]
    _native.require(lights, "lights", torch.float32, (n_lights, 2, 3), dev)
    _native.require(cam, "cam", torch.float32, (3,), dev)
    _native.require(random_seed, "random_seed", torch.float32, (), dev)
    _native.require(cos_sample_n, "cos_sample_n", torch.float32, (), dev)
    if config.rng not in RNG_MODES:
        raise ValueError(f"unknown rng mode {config.rng!r}")
    return n, n_lights, RNG_MODES[config.rng]


def _shade_launch(lib, stream, state, req, tex, ndc, lights, cam, random_seed, cos_sample_n,
                  i: int, config):
    n, n_lights, counter = _common(state, req, REQ_C, ndc, lights, cam, random_seed,
                                   cos_sample_n, config)
    _native.require(tex, "tex", torch.float32, (TEX_C, n), state.device)
    live, count = sp_live_list.run(lib, stream, state)
    _native.check(lib.fl_shade(
        _native.ptr(state), _native.ptr(req), _native.ptr(tex), _native.ptr(ndc),
        _native.ptr(lights), n_lights, _native.ptr(cam), _native.ptr(random_seed),
        _native.ptr(cos_sample_n), int(i), counter, n, _native.ptr(live), _native.ptr(count),
        stream), "shade")
    return state, req


def _alive_list_launch(lib, stream, state):
    """(list [N] int32, count [1] int32): the indices of the state's alive
    rays, in runs of ascending order (a warp's), and how many (the entries
    past the count are not written); m = 0 written for the other rays."""
    n = state.shape[1]
    _native.require(state, "state", torch.float32, (ST_C, n), state.device)
    live = torch.empty(n, dtype=torch.int32, device=state.device)
    count = torch.empty(1, dtype=torch.int32, device=state.device)
    _native.check(lib.fl_alive_list(_native.ptr(state), n, _native.ptr(live),
                                    _native.ptr(count), stream), "alive_list")
    return live, count


def _interp_shade_launch(lib, stream, state, req, ndc, mat, atlas, lights, cam, random_seed,
                         cos_sample_n, i: int, config):
    n, n_lights, counter = _common(state, req, REQ_STEP_C, ndc, lights, cam, random_seed,
                                   cos_sample_n, config)
    dev = state.device
    _native.require(mat, "mat", torch.float32, (mat.shape[0], 49), dev)
    _native.require(atlas, "atlas", torch.float32, (9,), dev)
    live, count = alive_list.run(lib, stream, state)
    _native.check(lib.fl_interp_shade(
        _native.ptr(state), _native.ptr(req), _native.ptr(ndc), _native.ptr(mat),
        _native.ptr(atlas), _native.ptr(lights), n_lights, _native.ptr(cam),
        _native.ptr(random_seed), _native.ptr(cos_sample_n), int(i), counter,
        config.min_importancy * SQRT3, n, _native.ptr(live), _native.ptr(count), stream),
        "interp_shade")
    return state, req


shade = _native.Kernel("shade", shade_plain, _shade_launch)
alive_list = _native.Kernel("alive_list", alive_list_plain, _alive_list_launch)
interp_shade = _native.Kernel("interp_shade", interp_shade_plain, _interp_shade_launch)
