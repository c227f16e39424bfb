"""PathTracer renderer (flexlight_tpu/models/pathtracer.py on torch).

One frame is: the MRT path-trace pass -> the post chain (post.chain:
temporal accumulation, the denoise chain, FXAA or TAA), run eagerly on
the renderer's device.

The hand-written kernels of the frame come in a `KernelSet`
(flexlight_tpu_torch.kernels): `KERNELS` (the default) holds the kernel
wrappers, `PLAIN` their plain PyTorch versions, which run the same frame
without any kernel of this package. A frame launches the traversal
kernels (scheme="kernel"), the fused PRE / POST kernels
(scheme="fused_split"), the whole-frame kernel (scheme="fused", never
picked by "auto") or the worklist kernels of large scenes
(scheme="sparse": tile flags, nearest2 sort key, closest hit, any hit),
and the filter and FXAA kernels either way; scheme="scan" and "packet",
flexlight_tpu's own casts in plain XLA, cast in plain PyTorch
(ops.traverse), and so do its CPU routes scheme="mxu" and "clustered"
(ops.traverse_mxu, ops.traverse_clustered). TAA (antialiasing="taa",
post.taa) is plain PyTorch, as in flexlight_tpu. The kernel and sparse
schemes shade each bounce in one kernel, interp_shade on scenes without
textures (1x1 atlases), else shade (<= 256 lights): by the renderer's
`shade_kernel` switch, None (the default: on a CUDA device where the
scene allows, else the eager loop), True (always; raises where no kernel
serves) or False (the eager loop, flexlight_tpu's default).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..kernels import KERNELS, KernelSet
from ..ops.pathtrace import render_mrt, resolve_scheme
from ..post.chain import postprocess_mrt
from ..post.taa import Jitter, TAAState, taa_history
from ..post.temporal import TemporalState
from ..utils.debug import assert_finite
from ..utils.timing import span
from .base import Renderer


def frame_pipeline(buffers, cam_pos, view, random_seed, temporal_state: TemporalState,
                   taa_state: TAAState | None, width: int, height: int, config: Config,
                   kernels: KernelSet = KERNELS, scheme: str = "kernel",
                   shade_kernel: bool | None = None, tile: int = 1024):
    """One full frame: MRT path-trace pass (traced: fl.render_mrt) + post.
    Returns (display, temporal state, TAA state)."""
    with span("fl.render_mrt"):
        mrt = render_mrt(buffers, width, height, cam_pos, view, config, random_seed,
                         scheme=scheme, kernels=kernels, shade_kernel=shade_kernel, tile=tile)
    return postprocess_mrt(mrt, temporal_state, taa_state, width, height, config, kernels)


class PathTracer(Renderer):
    """The path tracer with the reference's surface (render / halt /
    updateScene / updatePrimaryLightSources / fps / fpsLimit), on one
    explicit torch device. `shade_kernel` (an attribute too) picks how the
    bounces of the kernel and sparse schemes shade: None by the scene and
    the device, True in the kernels of ops.shade (a frame raises where they
    cannot serve), False eagerly (render_mrt). `tile` is the packet of
    scheme="packet"."""

    type = "pathtracer"

    def __init__(self, width, height, scene, camera, config, device,
                 scheme: str = "auto", kernels: KernelSet = KERNELS,
                 shade_kernel: bool | None = None, tile: int = 1024):
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
        """The scheme a frame runs: ops.pathtrace.resolve_scheme, "auto"
        taking "fused_split" for scenes within its caps."""
        if self.scheme == "auto" and self._buffers is None:
            self.update_scene()
        return resolve_scheme(self.scheme, self._buffers, fused=True)

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
