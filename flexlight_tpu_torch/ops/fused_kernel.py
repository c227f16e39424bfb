"""The kernel wrappers of scheme="fused_split": PRE and POST
(csrc/fused.cu), kernels 4 and 5 of the port, behind their plain versions
in ops.fused."""

from __future__ import annotations

import torch

from .. import _native
from .brdf import SQRT3
from .fused import SP_C, TEX_C, sp_post_plain, sp_pre_plain

_RNG_MODES = {"hash": 0, "counter": 1}


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


def _sp_pre_launch(lib, stream, state, dirs, w4, ids, mat, cam, resample: bool, config):
    n, tp = _scene_args(state, w4, ids, mat, cam)
    _native.require(dirs, "dirs", torch.float32, (3, n), state.device)
    _native.check(lib.fl_sp_pre(
        _native.ptr(state), _native.ptr(dirs), _native.ptr(w4), tp, _native.ptr(ids),
        _native.ptr(mat), _native.ptr(cam), int(bool(resample)),
        config.min_importancy * SQRT3, n, stream), "sp_pre")
    return state


def _sp_post_launch(lib, stream, state, tex, ndc, w4, ids, mat, lights, cam,
                    random_seed: float, cos_sample_n: float, i: int, config):
    n, tp = _scene_args(state, w4, ids, mat, cam)
    dev = state.device
    _native.require(tex, "tex", torch.float32, (TEX_C, n), dev)
    _native.require(ndc, "ndc", torch.float32, (2, n), dev)
    n_lights = lights.shape[0]
    _native.require(lights, "lights", torch.float32, (n_lights, 2, 3), dev)
    if config.rng not in _RNG_MODES:
        raise ValueError(f"unknown rng mode {config.rng!r}")
    _native.check(lib.fl_sp_post(
        _native.ptr(state), _native.ptr(tex), _native.ptr(ndc), _native.ptr(w4), tp,
        _native.ptr(ids), _native.ptr(mat), _native.ptr(lights), n_lights,
        _native.ptr(cam), float(random_seed), float(cos_sample_n), int(i),
        int(i + 1 < config.max_reflections), _RNG_MODES[config.rng],
        config.min_importancy * SQRT3, n, stream), "sp_post")
    return state


sp_pre = _native.Kernel(
    "sp_pre", sp_pre_plain, _sp_pre_launch,
    source="flexlight_tpu_torch/csrc/fused.cu",
    replaces="flexlight_tpu/ops/fused.py:872")
sp_post = _native.Kernel(
    "sp_post", sp_post_plain, _sp_post_launch,
    source="flexlight_tpu_torch/csrc/fused.cu",
    replaces="flexlight_tpu/ops/fused.py:944")
