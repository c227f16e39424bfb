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
hit), and the filter and FXAA kernels either way. With the renderer's
`shade_kernel` switch on (off by default, as in flexlight_tpu), the
kernel and sparse schemes shade each bounce in one kernel: interp_shade
on scenes without textures (1x1 atlases), else shade.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import Config
from ..ops.buffers import build_scene_buffers
from ..ops.fused import fused_split_eligible
from ..ops.fused_kernel import fused_frame, sp_post, sp_pre
from ..ops.intersect_kernel import any_hit, closest_hit
from ..ops.intersect_sparse_kernel import (sparse_any, sparse_closest, sparse_flags,
                                           sparse_key)
from ..ops.pathtrace import render_mrt
from ..ops.shade_kernel import interp_shade, shade
from ..post.common import quantize_rgba8, split_hdr
from ..post.filter_kernel import (final_blur, final_filter_packed, first_blur,
                                  first_filter_packed, pack_rgba8, second_blur,
                                  second_filter_packed, tileize_blur_key_packed)
from ..post.fxaa_kernel import fxaa_cuda
from ..post.temporal import TemporalState, push_frame, temporal_average
from ..utils.metrics import FrameMetrics, frame_record


class KernelSet(NamedTuple):
    """The kernels one frame launches, by role."""
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


KERNELS = KernelSet(closest_hit, any_hit, first_blur, second_blur, final_blur,
                    fxaa_cuda, sp_pre, sp_post, sparse_flags, sparse_key, sparse_closest,
                    sparse_any, shade, interp_shade, fused_frame)
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
                         kernels: KernelSet = KERNELS):
    """The first/second/final filter ping-pong on packed int32 [H, W]
    planes, index-exact to pathtracerWGL2.js:462-549: the first two
    second-pass originalColor writes land on a nonexistent attachment and
    are dropped, so the second second-pass reads a zero originalColor."""
    key_fn = tileize_blur_key_packed if config.filter_mode == "fast" else (lambda x: x)
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
            c, p, idout = first_filter_packed(*inputs, blur=kernels.first_blur)
            render[np_], ip[np_] = c, p
            ids[np_] = idout
        else:
            c, p, oc = second_filter_packed(*inputs, blur=kernels.second_blur)
            render[np_], ip[np_] = c, p
            if i - 2 >= first:
                ocolor[npo] = key_fn(oc)  # earlier second passes: dropped
        n = np_
        if i >= first:
            n_original = npo
        else:
            n_id = np_
    index = 2 + (first + second) % 2
    return final_filter_packed(render[index], ip[index], ocolor[second % 2],
                               ids[first % 2], oidp, config.hdr,
                               blur=kernels.final_blur)


def postprocess_mrt(mrt, temporal_state: TemporalState, width: int, height: int,
                    config: Config, kernels: KernelSet = KERNELS):
    """temporal -> denoise -> AA. Returns (display rgb [H,W,3] in [0,1],
    temporal state)."""
    if config.antialiasing == "taa":
        raise NotImplementedError("antialiasing='taa' is not ported yet (ROADMAP.md)")
    color, alpha, color_q, ip_q, id_q, oid_q, ocolor_q = _quantized_mrt(mrt, height, width)
    use_aa = config.antialiasing == "fxaa"
    if config.temporal:
        # randomSeed-synced accumulation ring (pathtracerWGL2.js:389-401)
        temporal_state = push_frame(temporal_state, color_q, ip_q, id_q, oid_q)
        t_color, t_glass, center_w = temporal_average(temporal_state)
        if config.filter:
            frac_q, high_q = split_hdr(t_color)
            r0 = torch.cat([frac_q, center_w[..., None]], dim=-1)
            ip0 = torch.cat([high_q, quantize_rgba8(t_glass)[..., None]], dim=-1)
            display = _filter_chain_packed(config, r0, ip0, ocolor_q, id_q, oid_q, kernels)
        else:
            # temporal-only output is raw and lands in an RGBA8 target
            display = torch.clamp(t_color, 0.0, 1.0)
            if use_aa:
                display = quantize_rgba8(display)
    elif config.filter:
        display = _filter_chain_packed(config, color_q, ip_q, ocolor_q, id_q, oid_q, kernels)
    else:
        # direct mode (glsl:625-632): fold in first-hit albedo, no tone map
        display = torch.clamp(color * mrt.original_color.reshape(height, width, 3), 0.0, 1.0)
    if use_aa:
        aa_in = torch.cat([quantize_rgba8(display),
                           (alpha > 0).to(torch.float32)[..., None]], dim=-1)
        display = kernels.fxaa(aa_in)[..., 0:3]
    return torch.clamp(display, 0.0, 1.0), temporal_state


def frame_pipeline(buffers, cam_pos, view, random_seed, temporal_state: TemporalState,
                   width: int, height: int, config: Config,
                   kernels: KernelSet = KERNELS, scheme: str = "kernel",
                   shade_kernel: bool = False):
    """One full frame: MRT path-trace pass + post."""
    mrt = render_mrt(buffers, width, height, cam_pos, view, config, random_seed,
                     scheme=scheme, kernels=kernels, shade_kernel=shade_kernel)
    return postprocess_mrt(mrt, temporal_state, width, height, config, kernels)


class PathTracer:
    """The renderer object with the reference's surface (render / halt /
    updateScene / updatePrimaryLightSources / fps / fpsLimit), on one
    explicit torch device. `shade_kernel` (an attribute too) shades the
    bounces of the kernel and sparse schemes in the kernels of ops.shade;
    a frame raises where they cannot serve (render_mrt)."""

    type = "pathtracer"
    # from this many triangles on, "auto" takes the sparse worklist casts
    # (flexlight_tpu/models/pathtracer.py:342)
    SPARSE_MIN_TRIS = 4096

    def __init__(self, width, height, scene, camera, config, device,
                 scheme: str = "auto", kernels: KernelSet = KERNELS,
                 shade_kernel: bool = False):
        self.scene = scene
        self.camera = camera
        self.config = config
        self.device = torch.device(device)
        self.canvas_width = int(width)
        self.canvas_height = int(height)
        self.scheme = scheme
        self.kernels = kernels
        self.shade_kernel = shade_kernel
        self.fps = 0.0
        self.fps_limit = float("inf")
        self.freeze = False
        self.metrics = FrameMetrics()
        self._halt = True
        self._last_frame = None
        self._last_frame_time = None
        self._buffers = None
        self._temporal_state = None
        self._frame_count = 0
        self._fps_window_start = time.perf_counter()
        self._fps_frames = 0
        self._prepared_shape = None
        self._transform_registry = None
        self._transform_version = None

    # size derived from renderQuality (pathtracerWGL2.js:809-812)
    @property
    def width(self) -> int:
        return max(int(self.canvas_width * self.config.render_quality), 1)

    @property
    def height(self) -> int:
        return max(int(self.canvas_height * self.config.render_quality), 1)

    def halt(self):
        self._halt = True

    def update_scene(self):
        self._buffers = build_scene_buffers(self.scene, self.device)
        self._transform_registry = None

    def resolved_scheme(self) -> str:
        """The scheme a frame runs. "auto" takes flexlight_tpu's rule on a
        chip (models/pathtracer.py:344-371) on every device: below
        SPARSE_MIN_TRIS triangles "fused_split" for scenes within its caps
        (<= 1024 triangles, <= 256 lights), else "kernel"; "sparse" from
        SPARSE_MIN_TRIS on. As in flexlight_tpu, "auto" never picks
        "fused": a caller asks for it."""
        if self.scheme == "auto":
            if self._buffers is None:
                self.update_scene()
            if self._buffers.id_buffer.shape[0] >= self.SPARSE_MIN_TRIS:
                return "sparse"
            return "fused_split" if fused_split_eligible(self._buffers) else "kernel"
        if self.scheme in ("kernel", "fused_split", "fused", "sparse"):
            return self.scheme
        raise NotImplementedError(
            f"scheme={self.scheme!r} is not ported yet (ROADMAP.md, Queue 1)")

    def update_primary_light_sources(self):
        if self._buffers is None:
            self.update_scene()
            return
        self._buffers = self._buffers._replace(
            lights=torch.as_tensor(self.scene.build_light_array(), device=self.device),
            ambient=torch.as_tensor(np.asarray(self.scene.ambient_light, dtype=np.float32),
                                    device=self.device))

    def _refresh_transforms(self):
        """Per-frame transform upload (pathtracerWGL2.js:361-363), skipped
        when nothing moved. The key holds the registry object itself, so a
        registry made after reset_global_registry() never matches a stale
        key by a reused address."""
        from ..scene.transform import global_registry

        reg = global_registry()
        if self._transform_registry is reg and self._transform_version == reg.version:
            return
        self._transform_registry = reg
        self._transform_version = reg.version
        rot, shift = reg.build_arrays()
        self._buffers = self._buffers._replace(
            rotations=torch.as_tensor(rot, device=self.device),
            shifts=torch.as_tensor(shift, device=self.device))

    # camelCase aliases (reference API)
    updateScene = update_scene
    updatePrimaryLightSources = update_primary_light_sources

    @property
    def fpsLimit(self):
        return self.fps_limit

    @fpsLimit.setter
    def fpsLimit(self, value):
        self.fps_limit = value

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
            self._frame_count = 0
            self._prepared_shape = shape

    def render_frame(self) -> np.ndarray:
        """Render one frame; returns [H, W, 3] float32 in [0, 1]."""
        return self._render_fetch(as_u8=False)

    def render_frame_u8(self) -> np.ndarray:
        """Like render_frame, quantized to uint8 on the device (the
        reference's RGBA8 canvas store)."""
        return self._render_fetch(as_u8=True)

    def _render_device(self) -> torch.Tensor:
        """Render one frame and return it on the device, [H, W, 3] f32."""
        scheme = self.resolved_scheme()
        if self._halt:
            self.render()
        if self.fps_limit != float("inf") and self._last_frame_time is not None:
            wait = 1.0 / self.fps_limit - (time.perf_counter() - self._last_frame_time)
            if wait > 0:
                time.sleep(wait)
        self._prepare()
        self._refresh_transforms()
        view = self.camera.view_matrix(self.width, self.height)
        temporal_frame = self._frame_count % self.config.temporal_samples
        random_seed = float(temporal_frame) if self.config.temporal else 0.0
        display, self._temporal_state = frame_pipeline(
            self._buffers, self.camera.position, view, random_seed,
            self._temporal_state, self.width, self.height, self.config,
            self.kernels, scheme=scheme, shade_kernel=self.shade_kernel)
        self._frame_count += 1
        return display

    def _render_fetch(self, as_u8: bool) -> np.ndarray:
        if self.freeze and self._last_frame is not None:
            return self._last_frame
        frame_t0 = time.perf_counter()
        display = self._render_device()
        if as_u8:
            display = torch.round(torch.clamp(display, 0.0, 1.0) * 255.0).to(torch.uint8)
        self._last_frame = display.cpu().numpy()
        self._fps_frames += 1
        now = time.perf_counter()
        self._last_frame_time = now
        elapsed = now - self._fps_window_start
        if elapsed > 0.5:  # 500 ms window (pathtracerWGL2.js:293-298)
            self.fps = self._fps_frames / elapsed
            self._fps_window_start = now
            self._fps_frames = 0
        frame_record(self, (now - frame_t0) * 1000.0, scheme=self.resolved_scheme())
        return self._last_frame
