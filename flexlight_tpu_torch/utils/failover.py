"""Failure detection + clean restart (flexlight_tpu/utils/failover.py on
torch; SURVEY §5 "failure detection / recovery").

The reference's only failure handling is a try/catch around GL context
loss (pathtracerWGL2.js:70-77) and a renderer-already-running guard
(pathtracerWGPU.js:145-148). Here a device can fail in two ways: a step
that never returns (a kernel that does not finish, a card that stops
answering: the interpreter is then blocked inside a native call, where
Python-level timeouts and signals do not fire), and a CUDA error, which
is sticky: every later call on the context fails too. So:

- **Detection** runs each frame in a worker thread and the supervisor
  times out the join: a hang is detected without the supervisor itself
  ever blocking on the device. Device exceptions (``RuntimeError("CUDA
  error: ...")``, ``torch.AcceleratorError``) propagate from the worker
  and are classified as device loss too; ``torch.OutOfMemoryError``
  propagates unchanged, as ``MemoryError`` does.
- **Recovery state must not come from the device.** A failed device
  cannot be read, so ``FailoverRunner`` refreshes a host-side numpy
  mirror of the accumulation state every ``mirror_every`` healthy frames
  (via checkpoint.snapshot_render_state) and, on failure, writes THAT
  mirror to the checkpoint path. Restart is then a clean process start +
  ``resume()`` — the scope SURVEY §5 sets ("checkpointed accumulation
  state and clean restart"), not in-process device resurrection, which a
  CUDA context that hit an error does not allow.

Usage:

    runner = FailoverRunner(renderer, "state.npz", mirror_every=8)
    runner.resume()                 # picks up a prior run, if any
    try:
        while True:
            frame = runner.step()
    except DeviceLostError as e:
        print(e)                    # checkpoint already written
        sys.exit(13)                # supervisor restarts the process
"""

from __future__ import annotations

import os
import threading
import time

from .checkpoint import (load_render_state, snapshot_render_state,
                         write_render_state)


class DeviceLostError(RuntimeError):
    """The device hung or errored; `checkpoint_path` holds the last
    healthy accumulation state (None if no frame ever completed and no
    prior checkpoint existed)."""

    def __init__(self, message: str, checkpoint_path: str | None):
        super().__init__(message)
        self.checkpoint_path = checkpoint_path


class FailoverRunner:
    """Supervised frame loop: watchdog-timed steps + host-mirrored
    checkpointing so a device loss costs at most `mirror_every` frames of
    accumulation."""

    def __init__(self, renderer, checkpoint_path: str,
                 mirror_every: int = 8, timeout_s: float = 120.0):
        self.renderer = renderer
        self.checkpoint_path = checkpoint_path
        self.mirror_every = max(int(mirror_every), 1)
        self.timeout_s = timeout_s
        self._mirror = None          # last healthy host-side snapshot
        self._steps_since_mirror = 0
        self.frames_rendered = 0

    # -- recovery ----------------------------------------------------------
    def resume(self) -> bool:
        """Load the checkpoint into the renderer if one exists. Returns
        True when state was restored (accumulation continues), False for a
        fresh start."""
        if not os.path.exists(self.checkpoint_path):
            return False
        load_render_state(self.checkpoint_path, self.renderer)
        return True

    # -- supervised stepping -------------------------------------------------
    def step(self, u8: bool = False):
        """Render one frame under the watchdog; returns the frame.

        Raises DeviceLostError after writing the last healthy mirror to
        the checkpoint path when the step hangs past `timeout_s` or dies
        with a runtime error."""
        result = {}

        def work():
            try:
                frame = (self.renderer.render_frame_u8() if u8
                         else self.renderer.render_frame())
                mirror = None
                if self._steps_since_mirror + 1 >= self.mirror_every:
                    mirror = snapshot_render_state(self.renderer)
                result["frame"] = frame
                result["mirror"] = mirror
            except BaseException as e:  # noqa: BLE001 — classified below
                result["error"] = e

        t = threading.Thread(target=work, daemon=True)
        t.start()
        t.join(self.timeout_s)
        if t.is_alive():
            # Blocked in native code; the worker thread is abandoned (it
            # cannot be interrupted) and the supervisor moves to recovery.
            self._fail(f"device step hung > {self.timeout_s:.0f}s")
        if "error" in result:
            err = result["error"]
            if _is_device_error(err):
                self._fail(f"device step failed: {err!r}")
            raise err  # programming errors propagate unchanged
        if result["mirror"] is not None:
            self._mirror = result["mirror"]
            self._steps_since_mirror = 0
        else:
            self._steps_since_mirror += 1
        self.frames_rendered += 1
        return result["frame"]

    def checkpoint_now(self) -> None:
        """Force a fresh device snapshot + write (healthy-path API)."""
        self._mirror = snapshot_render_state(self.renderer)
        self._steps_since_mirror = 0
        write_render_state(self.checkpoint_path, self._mirror)

    def _fail(self, why: str):
        wrote = None
        if self._mirror is not None:
            write_render_state(self.checkpoint_path, self._mirror)
            wrote = self.checkpoint_path
        elif os.path.exists(self.checkpoint_path):
            wrote = self.checkpoint_path  # prior run's checkpoint stands
        raise DeviceLostError(
            f"{why}; last healthy state "
            + (f"written to {wrote}" if wrote else "unavailable (no "
               "completed mirror and no prior checkpoint)"), wrote)


def _is_device_error(err: BaseException) -> bool:
    """Classify runtime/device failures vs ordinary Python errors.

    A CUDA fault surfaces as RuntimeError("CUDA error: ...") or, in newer
    torch, as torch.AcceleratorError, whose name matches none of Runtime,
    Internal or Unavailable. Running out of device memory
    (torch.OutOfMemoryError) is no device loss and propagates, as
    MemoryError does; anything else (TypeError, ValueError, assertion...)
    is a bug, not a device loss."""
    if isinstance(err, (FloatingPointError, MemoryError)):
        return False
    name = type(err).__name__
    if "OutOfMemory" in name:
        return False
    if ("Runtime" in name or "Internal" in name or "Unavailable" in name
            or "Accelerator" in name):
        return True
    return isinstance(err, OSError)


def run_supervised(renderer, checkpoint_path: str, frames: int,
                   mirror_every: int = 8, timeout_s: float = 120.0,
                   on_frame=None) -> int:
    """Convenience loop: resume + render `frames` frames; returns the
    number rendered this run. DeviceLostError propagates to the caller
    (whose supervisor restarts the process)."""
    runner = FailoverRunner(renderer, checkpoint_path,
                            mirror_every=mirror_every, timeout_s=timeout_s)
    runner.resume()
    for _ in range(frames):
        frame = runner.step()
        if on_frame is not None:
            on_frame(frame)
    runner.checkpoint_now()
    return runner.frames_rendered
