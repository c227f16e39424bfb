"""The system under test: flexlight_tpu_torch's engine, renderer and frame
server, driven as a viewer drives them. Besides the scene files'
`build_program`, this is the only module of the benchmark that imports
the program.

A `Session` builds a configuration's scene (`scenes/<scene>.py`) and
renderer, and records what the reference needs to check every frame:
each call made from outside on the engine's fly camera (WebIo), with the
harness's clock passed to it (`io_log`); for every render call, how many
of those came before it (`marks`), the camera pose the frame was
rendered from (`poses`) and a fingerprint of the frame the call
returned, so that a frame that reaches the viewer (as an array or as a
PNG) can be traced back to its frame number.
"""

from __future__ import annotations

import hashlib
import threading
import time

from . import spec


def fingerprint(frame) -> bytes:
    """A digest of a strided sample of a [H, W, 3] uint8 frame: cheap on
    the render thread; frames that share one are told apart by equality
    (Session.call_of)."""
    return hashlib.blake2b(frame[::61, ::53].tobytes(), digest_size=16).digest()


def pose_of(camera) -> tuple:
    return (float(camera.x), float(camera.y), float(camera.z), float(camera.fx),
            float(camera.fy))


def clock_ms() -> float:
    """The harness's clock, in ms."""
    return time.perf_counter() * 1000.0


class Session:
    """One configuration's engine on `device`, with the stand-in assets of
    its `assets_seed` (files of a scene go under `tmpdir`)."""

    def __init__(self, cfg: dict, device, tmpdir: str):
        from flexlight_tpu_torch import Config, reset_global_registry

        reset_global_registry()
        engine, self.animate = spec.part("scenes", cfg["scene"]).build_program(
            cfg, device, tmpdir)
        engine.canvas = (cfg["width"], cfg["height"])
        engine.config = Config(**cfg["config"])
        engine.renderer = cfg["renderer"]
        self.engine = engine
        self.renderer = engine.renderer
        self.renderer.scheme = cfg["scheme"]
        self.depth = 0
        if hasattr(self.renderer, "pipelined"):
            self.renderer.pipelined = self.depth = int(cfg["pipelined"])
        self.io = engine.io
        self.io_log = []         # (call, arguments..., now_ms) on the WebIo from outside
        self.marks = []          # len(io_log) at each render call
        self.poses = []          # pose of the frame each call rendered
        self.returned = []       # fingerprint of the frame each call returned
        self.frames = None       # with keep_frames(): the frame each call returned
        # one viewer call or render call at a time, in the order logged;
        # the frame server's input handlers wait while a frame renders
        self.lock = threading.RLock()
        self._nested = 0
        self._io_methods = {n: getattr(self.io, n)
                            for n in ("key_down", "key_up", "update", "mouse_move")}
        for name in ("key_down", "key_up"):
            setattr(self.io, name, self._key_call(name))
        self.io.update = self._update_call
        self.io.mouse_move = self._mouse_call
        self._render = self.renderer.render_frame_u8
        # the frame server looks the method up on the renderer: route it here
        self.renderer.render_frame_u8 = self.render_frame_u8

    def _logged(self, entry: tuple, call):
        """Log a call from outside the WebIo (not one it makes itself, as
        key_down's update) and make it."""
        with self.lock:
            if not self._nested:
                self.io_log.append(entry)
            self._nested += 1
            try:
                call()
            finally:
                self._nested -= 1

    def _key_call(self, name: str):
        method = self._io_methods[name]

        def call(key, now_ms=None):
            now_ms = clock_ms() if now_ms is None else float(now_ms)
            self._logged((name, key, now_ms), lambda: method(key, now_ms))

        return call

    def _update_call(self, now_ms=None):
        now_ms = clock_ms() if now_ms is None else float(now_ms)
        self._logged(("update", now_ms), lambda: self._io_methods["update"](now_ms))

    def _mouse_call(self, dx, dy, width=512, height=512):
        self._logged(("mouse_move", float(dx), float(dy)),
                     lambda: self._io_methods["mouse_move"](dx, dy, width, height))

    def scheme(self) -> str:
        return self.renderer.resolved_scheme()

    def record(self) -> dict:
        return {"io_log": list(self.io_log), "marks": list(self.marks),
                "poses": list(self.poses)}

    def render_frame_u8(self):
        """The renderer's render_frame_u8, after the scene's own per-frame
        animation, recording the pose and the returned frame."""
        with self.lock:
            if self.animate is not None:
                self.animate(len(self.poses))
            self.marks.append(len(self.io_log))
            self.poses.append(pose_of(self.engine.camera))
            frame = self._render()
        self.returned.append(fingerprint(frame))
        if self.frames is not None:
            self.frames.append(frame)
        return frame

    def keep_frames(self):
        """From now on keep every returned frame (each is its own array),
        so that a frame received elsewhere can be matched exactly."""
        self.frames = [None] * len(self.poses)

    def call_of(self, frame):
        """The last call that returned exactly `frame`, or None."""
        fp = fingerprint(frame)
        for call in range(len(self.returned) - 1, -1, -1):
            if self.returned[call] == fp and self.frames[call] is not None \
                    and (self.frames[call] == frame).all():
                return call
        return None

    def frame_of_call(self, call: int) -> int:
        """The frame a call returns with `pipelined` = depth: frame
        call - depth once the pipeline is full (models/pathtracer.py)."""
        return max(call - self.depth, 0)

    def apply(self, event, now_ms: float):
        """One traffic event on the engine's WebIo, at the harness's clock."""
        kind = event[1]
        if kind == "keydown":
            self.io.key_down(event[2], now_ms)
        elif kind == "keyup":
            self.io.key_up(event[2], now_ms)
        else:
            w, h = self.engine.canvas
            self.io.mouse_move(event[2], event[3], w, h)

    def warm_up(self, frames: int):
        """Render `frames` frames from the start pose: every kernel of the
        cell's shape is built and loaded, and the pipeline is full."""
        for _ in range(frames):
            self.io.update(clock_ms())
            self.render_frame_u8()

    def server(self):
        from flexlight_tpu_torch.serve import FrameServer

        return FrameServer(self.engine, host="127.0.0.1", port=0)

    def renderer_records(self):
        """(time.time() stamp, host ms) of each frame the renderer's
        metrics ring still holds (utils.metrics.frame_record)."""
        return [(r["ts"], r["frame_ms"]) for r in self.renderer.metrics.records]

    def close(self):
        """Drop the program's state so its memory returns to the device."""
        self.renderer.render_frame_u8 = self._render
        for name in self._io_methods:
            delattr(self.io, name)
        self.engine = self.renderer = self.io = self._render = self.animate = None
        self._io_methods = {}
        self.frames = None
