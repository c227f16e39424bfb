"""The frame's post chain: the RGBA8 store of the MRT, temporal
accumulation, the denoise ping-pong and the AA tail (FXAA or TAA), run
eagerly on the frame's device.

One implementation serves the one-process frame (models.pathtracer) and
the halo-sharded frame (parallel.tile_sharding), which passes its halo
`lift`, its sharded blur key `tileize` and its clamped `taa_step`; the
rasterizer shares the AA tail (`antialias`). The filter ping-pong is
replicated with static Python indices, including the reference's
dropped-attachment quirks (`filter_chain_packed`)."""

from __future__ import annotations

from functools import partial

import torch

from ..config import Config
from ..kernels import KERNELS, KernelSet
from ..utils.timing import span
from .common import quantize_rgba8, split_hdr
from .filter_kernel import (final_filter_packed, first_filter_packed, pack_rgba8,
                            second_filter_packed, tileize_blur_key_packed)
from .taa import TAAState, taa_apply
from .temporal import TemporalState, push_frame, temporal_average


def quantized_mrt(mrt, height: int, width: int):
    """Flat MRT -> images, with the RGBA8 store quantization of the
    reference's render targets (pathtracerWGL2.js:790-806)."""
    def img(x, c=None):
        return x.reshape(height, width) if c is None else x.reshape(height, width, c)

    color = img(mrt.color, 3)
    alpha = img(mrt.alpha)
    frac_q, high_q = split_hdr(color)
    color_q = torch.cat([frac_q, alpha[..., None]], dim=-1)
    ip_q = torch.cat([high_q, quantize_rgba8(img(mrt.glass))[..., None]], dim=-1)
    id_q = quantize_rgba8(img(mrt.render_id, 4))
    oid_q = torch.cat([torch.zeros_like(color),
                       quantize_rgba8(img(mrt.original_id_w))[..., None]], dim=-1)
    ocolor_q = quantize_rgba8(torch.cat(
        [img(mrt.original_color, 3), img(mrt.original_w)[..., None]], dim=-1))
    return color, alpha, color_q, ip_q, id_q, oid_q, ocolor_q


def filter_chain_packed(config: Config, r0, ip0, oc0, id0, oid,
                        kernels: KernelSet = KERNELS, lift=None, tileize=None):
    """The first/second/final filter ping-pong on packed int32 [H, W]
    planes, index-exact to pathtracerWGL2.js:462-549: the first two
    second-pass originalColor writes land on a nonexistent attachment and
    are dropped, so the second second-pass reads a zero originalColor.

    `lift` wraps each pass (the halo-sharded frame exchanges halo rows
    around it, parallel.halo.with_halo; flexlight_tpu lifts its float
    chain, models/pathtracer.py:149-165, and packing is lossless, so the
    values are the same). `tileize` is the fast mode's blur-key quantizer
    on a packed plane (default post.filter_kernel.tileize_blur_key_packed;
    the sharded frame passes its all-reduce form,
    parallel.tile_sharding.tileize_blur_key_sharded)."""
    lift = (lambda f: f) if lift is None else lift
    if config.filter_mode == "fast":
        key_fn = tileize_blur_key_packed if tileize is None else tileize
    else:
        key_fn = lambda x: x  # noqa: E731
    first_fn = lift(partial(first_filter_packed, blur=kernels.first_blur))
    second_fn = lift(partial(second_filter_packed, blur=kernels.second_blur))
    final_fn = lift(partial(final_filter_packed, hdr=config.hdr, blur=kernels.final_blur))
    r0p, ip0p, oc0p, id0p, oidp = (pack_rgba8(x) for x in (r0, ip0, oc0, id0, oid))
    zeros = torch.zeros_like(r0p)
    render = {0: r0p, 1: zeros, 2: zeros, 3: zeros}
    ip = {0: ip0p, 1: zeros, 2: zeros, 3: zeros}
    ids = {0: id0p, 1: zeros}
    ocolor = {0: key_fn(oc0p), 1: zeros}
    n = n_id = n_original = 0
    first, second = config.first_passes, config.second_passes
    for i in range(first + second):
        np_ = (i % 2) ^ 1
        npo = ((i - first) % 2) ^ 1
        if i >= first:
            np_ += 2
        inputs = (render[n], ip[n], ocolor[n_original], ids[n_id], oidp)
        if i < first:
            c, p, idout = first_fn(*inputs)
            render[np_], ip[np_] = c, p
            ids[np_] = idout
        else:
            c, p, oc = second_fn(*inputs)
            render[np_], ip[np_] = c, p
            if i - 2 >= first:
                ocolor[npo] = key_fn(oc)  # earlier second passes: dropped
        n = np_
        if i >= first:
            n_original = npo
        else:
            n_id = np_
    index = 2 + (first + second) % 2
    return final_fn(render[index], ip[index], ocolor[second % 2], ids[first % 2], oidp)


def antialias(display, alpha, coverage, taa_state: TAAState | None, config: Config, fxaa,
              lift=None, taa_step=None):
    """The AA tail of a frame: the display's RGBA8 store beside the
    coverage channel `coverage(alpha)`, then FXAA (`fxaa`, wrapped in
    `lift` where given) or one TAA step (`taa_step(state, aa_in) -> (out,
    state)`, default post.taa.taa_apply on the whole history). Returns
    (rgb [H, W, 3], TAA state). Traced: fl.aa."""
    with span("fl.aa"):
        aa_in = torch.cat([quantize_rgba8(display), coverage(alpha)[..., None]], dim=-1)
        if config.antialiasing == "fxaa":
            display = (fxaa if lift is None else lift(fxaa))(aa_in)[..., 0:3]
        else:
            out, taa_state = (taa_apply if taa_step is None else taa_step)(taa_state, aa_in)
            display = out[..., 0:3]
    return display, taa_state


def _covered(alpha):
    return (alpha > 0).to(torch.float32)


def postprocess_mrt(mrt, temporal_state: TemporalState, taa_state: TAAState | None,
                    width: int, height: int, config: Config, kernels: KernelSet = KERNELS,
                    lift=None, tileize=None, taa_step=None):
    """temporal -> denoise -> AA on a frame's MRT of `height` rows (the
    whole image, or a strip of it). Returns (display rgb [H,W,3] in [0,1],
    temporal state, TAA state; None unless antialiasing="taa"). `lift`
    wraps each filter pass and FXAA, `tileize` is the fast mode's blur
    key and `taa_step` the TAA step (filter_chain_packed, antialias); the
    defaults are the one-process frame's. Traced: fl.post, over
    fl.temporal, fl.filter and fl.aa."""
    with span("fl.post"):
        color, alpha, color_q, ip_q, id_q, oid_q, ocolor_q = quantized_mrt(mrt, height, width)
        chain = partial(filter_chain_packed, config, kernels=kernels, lift=lift, tileize=tileize)
        use_aa = config.antialiasing in ("fxaa", "taa")
        if config.temporal:
            # randomSeed-synced accumulation ring (pathtracerWGL2.js:389-401)
            with span("fl.temporal"):
                temporal_state = push_frame(temporal_state, color_q, ip_q, id_q, oid_q)
                t_color, t_glass, center_w = temporal_average(temporal_state)
            if config.filter:
                with span("fl.filter"):
                    frac_q, high_q = split_hdr(t_color)
                    r0 = torch.cat([frac_q, center_w[..., None]], dim=-1)
                    ip0 = torch.cat([high_q, quantize_rgba8(t_glass)[..., None]], dim=-1)
                    display = chain(r0, ip0, ocolor_q, id_q, oid_q)
            else:
                # temporal-only output is raw and lands in an RGBA8 target
                display = torch.clamp(t_color, 0.0, 1.0)
                if use_aa:
                    display = quantize_rgba8(display)
        elif config.filter:
            with span("fl.filter"):
                display = chain(color_q, ip_q, ocolor_q, id_q, oid_q)
        else:
            # direct mode (glsl:625-632): fold in first-hit albedo, no tone map
            display = torch.clamp(color * mrt.original_color.reshape(height, width, 3), 0.0, 1.0)
        if use_aa:
            display, taa_state = antialias(display, alpha, _covered, taa_state, config,
                                           kernels.fxaa, lift, taa_step)
        return torch.clamp(display, 0.0, 1.0), temporal_state, taa_state
