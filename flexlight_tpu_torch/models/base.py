"""The surface the port's three renderers share (flexlight_tpu repeats it
in each of models/pathtracer.py, rasterizer.py and simple.py): the size
from renderQuality, halt, fpsLimit, freeze, fps, metrics,
updateScene / updatePrimaryLightSources, the per-frame transform upload
and the fetch (`_fetch`) and bookkeeping of a finished frame, on one
explicit torch device. A renderer gives `_render_device` (one frame, on
the device) and what its metrics record beside the standard fields
(`_frame_extra`)."""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.buffers import AtlasTable, build_scene_buffers
from ..utils.metrics import FrameMetrics, frame_record
from ..utils.timing import span, tracing


class Renderer:
    type = "renderer"

    def __init__(self, width, height, scene, camera, config, device):
        self.scene = scene
        self.camera = camera
        self.config = config
        self.device = torch.device(device)
        self.canvas_width = int(width)
        self.canvas_height = int(height)
        self.fps = 0.0
        self.fps_limit = float("inf")
        # `freeze` pauses rendering: render_frame returns the last frame
        # (the reference's surface, obj.js:72 / highpoly.js:490)
        self.freeze = False
        self.metrics = FrameMetrics()
        self._halt = True
        self._last_frame = None
        self._last_frame_time = None
        self._buffers = None
        self._frame_count = 0
        self._fps_window_start = time.perf_counter()
        self._fps_frames = 0
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
        """Flatten the scene and upload it anew. Traced, the span
        fl.scene.update {triangles, lights, bytes, copies}: `copies` is the
        number of tensors the upload made on the device, `bytes` their
        size."""
        with span("fl.scene.update") as scene_span:
            self._buffers = build_scene_buffers(self.scene, self.device)
            self._transform_registry = None
            if tracing():
                tensors = [t for field in self._buffers
                           for t in (field if isinstance(field, AtlasTable) else (field,))]
                scene_span.set(triangles=int(self._buffers.id_buffer.shape[0]),
                               lights=int(self._buffers.lights.shape[0]),
                               bytes=sum(t.nbytes for t in tensors), copies=len(tensors))

    def update_primary_light_sources(self):
        if self._buffers is None:
            self.update_scene()
            return
        self._buffers = self._buffers._replace(
            lights=torch.as_tensor(self.scene.build_light_array(), device=self.device),
            ambient=torch.as_tensor(np.asarray(self.scene.ambient_light, dtype=np.float32),
                                    device=self.device))

    # camelCase aliases (reference API), through the subclass's methods
    def updateScene(self):
        self.update_scene()

    def updatePrimaryLightSources(self):
        self.update_primary_light_sources()

    @property
    def fpsLimit(self):
        return self.fps_limit

    @fpsLimit.setter
    def fpsLimit(self, value):
        self.fps_limit = value

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

    def render_frame(self) -> np.ndarray:
        """Render one frame; returns [H, W, 3] float32 in [0, 1]."""
        return self._render_fetch(as_u8=False)

    def render_frame_u8(self) -> np.ndarray:
        """Like render_frame, quantized to uint8 on the device (the
        reference's RGBA8 canvas store)."""
        return self._render_fetch(as_u8=True)

    def _render_device(self) -> torch.Tensor:
        """Render one frame and return it on the device, [H, W, 3] f32."""
        raise NotImplementedError

    def _frame_extra(self) -> dict:
        """What the frame's metrics record beside the standard fields."""
        return {}

    def _render_fetch(self, as_u8: bool) -> np.ndarray:
        """Render a frame, fetch it to the host (as uint8 with `as_u8`: the
        reference's RGBA8 canvas store), update fps (a 500 ms window,
        pathtracerWGL2.js:293-298) and record the frame's metrics. Traced,
        the frame is the span fl.frame {frame, scheme}, the fetch fl.fetch."""
        if self.freeze and self._last_frame is not None:
            return self._last_frame
        with span("fl.frame") as frame_span:
            frame_t0 = time.perf_counter()
            display = self._render_device()
            with span("fl.fetch"):
                if as_u8:
                    display = torch.round(torch.clamp(display, 0.0, 1.0) * 255.0).to(torch.uint8)
                self._last_frame = self._fetch(display)
            self._fps_frames += 1
            now = time.perf_counter()
            self._last_frame_time = now
            elapsed = now - self._fps_window_start
            if elapsed > 0.5:
                self.fps = self._fps_frames / elapsed
                self._fps_window_start = now
                self._fps_frames = 0
            extra = self._frame_extra()
            frame_record(self, (now - frame_t0) * 1000.0, **extra)
            frame_span.set(frame=self._frame_count, **extra)
        return self._last_frame

    def _fetch(self, display: torch.Tensor) -> np.ndarray:
        """The finished frame on the host (a synchronous copy: the span
        fl.fetch_wait)."""
        with span("fl.fetch_wait"):
            return display.cpu().numpy()

    def _throttle(self):
        """fpsLimit: wait out the rest of the frame's share of a second."""
        if self.fps_limit != float("inf") and self._last_frame_time is not None:
            wait = 1.0 / self.fps_limit - (time.perf_counter() - self._last_frame_time)
            if wait > 0:
                time.sleep(wait)
