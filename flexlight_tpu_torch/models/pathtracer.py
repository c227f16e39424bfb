"""PathTracer renderer (flexlight_tpu/models/pathtracer.py on torch).

One frame is: the MRT path-trace pass -> temporal accumulation -> the
denoise chain -> FXAA, run eagerly on the renderer's device. The
reference's filter ping-pong is replicated with static Python indices,
including its dropped-attachment quirks (`_filter_chain_packed`).

The hand-written kernels of the frame come in a `KernelSet`: `KERNELS`
(the default) holds the kernel wrappers, `PLAIN` their plain PyTorch
versions, which run the same frame without any kernel of this package.
A frame launches the traversal kernels (scheme="kernel"), the fused
PRE / POST kernels (scheme="fused_split"), the whole-frame kernel
(scheme="fused", never picked by "auto") or the worklist kernels of large
scenes (scheme="sparse": tile flags, nearest2 sort key, closest hit, any
hit), and the filter and FXAA kernels either way; scheme="scan" and
"packet", flexlight_tpu's own casts in plain XLA, cast in plain PyTorch
(ops.traverse), and so do its CPU routes scheme="mxu" and "clustered"
(ops.traverse_mxu, ops.traverse_clustered). TAA (antialiasing="taa",
post.taa) is plain PyTorch, as in flexlight_tpu. With the renderer's
`shade_kernel` switch on (off by default, as in flexlight_tpu), the
kernel and sparse schemes shade each bounce in one kernel: interp_shade
on scenes without textures (1x1 atlases), else shade.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import Config
from ..ops.fused import fused_split_eligible
from ..ops.fused_kernel import fused_frame, sp_post, sp_pre
from ..ops.intersect_kernel import any_hit, closest_hit
from ..ops.intersect_sparse_kernel import (sparse_any, sparse_closest, sparse_flags,
                                           sparse_key)
from ..ops.pathtrace import render_mrt
from ..ops.raster_kernel import raster_rays, raster_shade, raster_surface
from ..ops.shade_kernel import interp_shade, shade
from ..post.common import quantize_rgba8, split_hdr
from ..post.filter_kernel import (final_blur, final_filter_packed, first_blur,
                                  first_filter_packed, pack_rgba8, second_blur,
                                  second_filter_packed, tileize_blur_key_packed)
from ..post.fxaa_kernel import fxaa_cuda
from ..post.taa import Jitter, TAAState, taa_apply, taa_history
from ..post.temporal import TemporalState, push_frame, temporal_average
from ..utils.debug import assert_finite
from ..utils.timing import span
from .base import Renderer


class KernelSet(NamedTuple):
    """The kernels one frame launches, by role. The rasterizer takes the
    same set: its casts, FXAA, and its shading of a hit layer
    (raster_surface, raster_rays, raster_shade: ops.raster_kernel)."""
    closest_hit: Callable
    any_hit: Callable
    first_blur: Callable
    second_blur: Callable
    final_blur: Callable
    fxaa: Callable
    sp_pre: Callable
    sp_post: Callable
    sparse_flags: Callable
    sparse_key: Callable
    sparse_closest: Callable
    sparse_any: Callable
    shade: Callable
    interp_shade: Callable
    fused_frame: Callable
    raster_surface: Callable
    raster_rays: Callable
    raster_shade: Callable


KERNELS = KernelSet(closest_hit, any_hit, first_blur, second_blur, final_blur,
                    fxaa_cuda, sp_pre, sp_post, sparse_flags, sparse_key, sparse_closest,
                    sparse_any, shade, interp_shade, fused_frame, raster_surface, raster_rays,
                    raster_shade)
PLAIN = KernelSet(*(k.plain for k in KERNELS))


def _quantized_mrt(mrt, height: int, width: int):
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


def _filter_chain_packed(config: Config, r0, ip0, oc0, id0, oid,
                         kernels: KernelSet = KERNELS, lift=None, tileize=None):
    """The first/second/final filter ping-pong on packed int32 [H, W]
    planes, index-exact to pathtracerWGL2.js:462-549: the first two
    second-pass originalColor writes land on a nonexistent attachment and
    are dropped, so the second second-pass reads a zero originalColor.

    `lift` wraps each pass (the halo-sharded pipeline exchanges halo rows
    around it, parallel.halo.with_halo; flexlight_tpu lifts its float
    chain, models/pathtracer.py:149-165, and packing is lossless, so the
    values are the same). `tileize` is the fast mode's blur-key quantizer
    on a packed plane (default post.filter_kernel.tileize_blur_key_packed;
    the sharded pipeline passes its all-reduce form,
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


def postprocess_mrt(mrt, temporal_state: TemporalState, taa_state: TAAState | None,
                    width: int, height: int, config: Config, kernels: KernelSet = KERNELS):
    """temporal -> denoise -> AA. Returns (display rgb [H,W,3] in [0,1],
    temporal state, TAA state; None unless antialiasing="taa"). Traced:
    fl.post, over fl.temporal, fl.filter and fl.aa."""
    with span("fl.post"):
        color, alpha, color_q, ip_q, id_q, oid_q, ocolor_q = _quantized_mrt(mrt, height, width)
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
                    display = _filter_chain_packed(config, r0, ip0, ocolor_q, id_q, oid_q,
                                                   kernels)
            else:
                # temporal-only output is raw and lands in an RGBA8 target
                display = torch.clamp(t_color, 0.0, 1.0)
                if use_aa:
                    display = quantize_rgba8(display)
        elif config.filter:
            with span("fl.filter"):
                display = _filter_chain_packed(config, color_q, ip_q, ocolor_q, id_q, oid_q,
                                               kernels)
        else:
            # direct mode (glsl:625-632): fold in first-hit albedo, no tone map
            display = torch.clamp(color * mrt.original_color.reshape(height, width, 3), 0.0, 1.0)
        if use_aa:
            with span("fl.aa"):
                aa_in = torch.cat([quantize_rgba8(display),
                                   (alpha > 0).to(torch.float32)[..., None]], dim=-1)
                if config.antialiasing == "fxaa":
                    display = kernels.fxaa(aa_in)[..., 0:3]
                else:
                    out, taa_state = taa_apply(taa_state, aa_in)
                    display = out[..., 0:3]
        return torch.clamp(display, 0.0, 1.0), temporal_state, taa_state


def frame_pipeline(buffers, cam_pos, view, random_seed, temporal_state: TemporalState,
                   taa_state: TAAState | None, width: int, height: int, config: Config,
                   kernels: KernelSet = KERNELS, scheme: str = "kernel",
                   shade_kernel: bool = False, tile: int = 1024):
    """One full frame: MRT path-trace pass (traced: fl.render_mrt) + post.
    Returns (display, temporal state, TAA state)."""
    with span("fl.render_mrt"):
        mrt = render_mrt(buffers, width, height, cam_pos, view, config, random_seed,
                         scheme=scheme, kernels=kernels, shade_kernel=shade_kernel, tile=tile)
    return postprocess_mrt(mrt, temporal_state, taa_state, width, height, config, kernels)


class PathTracer(Renderer):
    """The path tracer with the reference's surface (render / halt /
    updateScene / updatePrimaryLightSources / fps / fpsLimit), on one
    explicit torch device. `shade_kernel` (an attribute too) shades the
    bounces of the kernel and sparse schemes in the kernels of ops.shade;
    a frame raises where they cannot serve (render_mrt). `tile` is the
    packet of scheme="packet"."""

    type = "pathtracer"
    # from this many triangles on, "auto" takes the sparse worklist casts
    # (flexlight_tpu/models/pathtracer.py:342)
    SPARSE_MIN_TRIS = 4096
    SCHEMES = ("kernel", "fused_split", "fused", "sparse", "scan", "packet", "mxu", "clustered")

    def __init__(self, width, height, scene, camera, config, device,
                 scheme: str = "auto", kernels: KernelSet = KERNELS,
                 shade_kernel: bool = False, tile: int = 1024):
        super().__init__(width, height, scene, camera, config, device)
        self.scheme = scheme
        self.kernels = kernels
        self.shade_kernel = shade_kernel
        self.tile = tile
        self._temporal_state = None
        self._taa_state = None
        self._jitter = Jitter()
        self._prepared_shape = None
        # The swapchain fetch: render_frame returns frame N-k while frame N
        # computes. `pipelined` is the depth k: False / 0 = synchronous,
        # True / 1 = double buffer, 2-4 = deeper (flexlight_tpu's
        # PathTracer.pipelined). The queue holds the frames whose
        # device -> host copies are in flight.
        self.pipelined = False
        self._pending_display = []

    def resolved_scheme(self) -> str:
        """The scheme a frame runs. "auto" takes flexlight_tpu's rule on a
        chip (models/pathtracer.py:344-371) on every device: below
        SPARSE_MIN_TRIS triangles "fused_split" for scenes within its caps
        (<= 1024 triangles, <= 256 lights), else "kernel"; "sparse" from
        SPARSE_MIN_TRIS on. As in flexlight_tpu on a chip, "auto" never
        picks "fused", "scan", "packet", "mxu" or "clustered": a caller
        asks for them (flexlight_tpu's CPU branch to mxu / clustered is
        left behind, ROADMAP.md)."""
        if self.scheme == "auto":
            if self._buffers is None:
                self.update_scene()
            if self._buffers.id_buffer.shape[0] >= self.SPARSE_MIN_TRIS:
                return "sparse"
            return "fused_split" if fused_split_eligible(self._buffers) else "kernel"
        if self.scheme in self.SCHEMES:
            return self.scheme
        raise ValueError(f"unknown scheme {self.scheme!r}; the path tracer takes 'auto' or "
                         f"one of {self.SCHEMES}")

    def render(self):
        """Prepare buffers and state; frames then come from render_frame()."""
        self._halt = False
        self._prepare()

    def _prepare(self):
        if self._buffers is None:
            self.update_scene()
        shape = (self.height, self.width, self.config)
        if self._prepared_shape != shape:
            self._temporal_state = TemporalState.create(
                self.config.temporal_samples, self.height, self.width, self.device)
            self._taa_state = taa_history(self.config.antialiasing, self.height,
                                          self.width, self.device)
            self._frame_count = 0
            self._prepared_shape = shape
            self._pending_display = []

    def _render_device(self) -> torch.Tensor:
        scheme = self.resolved_scheme()
        if self._halt:
            self.render()
        self._throttle()
        self._prepare()
        self._refresh_transforms()
        jitter = (0.0, 0.0)
        if self.config.antialiasing == "taa":
            jitter = self._jitter.next(self.width, self.height)
        view = self.camera.view_matrix(self.width, self.height, jitter)
        temporal_frame = self._frame_count % self.config.temporal_samples
        random_seed = float(temporal_frame) if self.config.temporal else 0.0
        display, self._temporal_state, self._taa_state = frame_pipeline(
            self._buffers, self.camera.position, view, random_seed,
            self._temporal_state, self._taa_state, self.width, self.height, self.config,
            self.kernels, scheme=scheme, shade_kernel=self.shade_kernel, tile=self.tile)
        self._frame_count += 1
        assert_finite((display, self._temporal_state, self._taa_state), "pathtracer.frame")
        return display

    def _fetch(self, display: torch.Tensor) -> np.ndarray:
        """With `pipelined` = k, start this frame's copy to the host and
        return frame N-k, as flexlight_tpu does: during warm-up the oldest
        queued frame (frame 0 for the first k + 1 calls, then 1, 2, ...),
        and a lowered depth drains the queue at once. A returned array is
        the frame's own (`_HostCopy`): no later copy writes into it."""
        depth = int(self.pipelined)
        if not depth:
            return super()._fetch(display)
        self._pending_display.append(_HostCopy(display))
        if len(self._pending_display) > depth:
            while len(self._pending_display) > depth:
                frame = self._pending_display.pop(0)
        else:
            frame = self._pending_display[0]
        return frame.result()

    def _frame_extra(self) -> dict:
        return {"scheme": self.resolved_scheme()}


class _HostCopy:
    """A frame's device -> host copy in flight. On a CUDA device the copy
    goes into pinned host memory with non_blocking=True on the stream that
    made the frame, and an event marks its end: the host goes on to the
    next frame, and `result()` waits for that event only. The copy is
    enqueued before this returns, so the device tensor may be freed at
    once: the stream orders its reuse after the copy. `result()` returns
    a fresh array copied out of the pinned buffer, which then goes back to
    torch's caching host allocator for a later frame: a pinned block is
    handed out again only after the events of its copies have passed, and
    no later copy writes into a returned array. A CPU frame is its own
    host array."""

    def __init__(self, display: torch.Tensor):
        if display.device.type == "cuda":
            self.host = torch.empty(display.shape, dtype=display.dtype, pin_memory=True)
            self.host.copy_(display, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(display.device))
        else:
            self.host = display
            self.event = None
        self._array = None

    def result(self) -> np.ndarray:
        """The frame's array, once its copy has ended (traced, the wait on
        its event is fl.fetch_wait)."""
        if self._array is None:
            if self.event is None:
                self._array = self.host.numpy()
            else:
                with span("fl.fetch_wait"):
                    self.event.synchronize()
                self._array = self.host.numpy().copy()
            self.host = None
        return self._array
