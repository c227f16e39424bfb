"""Tracing / profiling utilities (flexlight_tpu/utils/timing.py on torch).

The reference only counts FPS over 500 ms windows (pathtracerWGL2.js:293-298).
Here timing is first-class: per-pass wall clock, ms/frame and Mrays/s
counters (`FrameStats`, the same as flexlight_tpu's), a torch.profiler
trace context that writes a Chrome trace, and the NaN / Inf guard of the
port's debug mode.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class FrameStats:
    """Rolling per-pass timings + derived renderer metrics."""

    def __init__(self, window: float = 0.5):
        self.window = window
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.fps = 0.0
        self._frames = 0
        self._window_start = time.perf_counter()

    @contextlib.contextmanager
    def time_pass(self, name: str):
        """Wall-clock a pass; synchronize the device inside the block for
        honest device timing."""
        t0 = time.perf_counter()
        yield
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def end_frame(self) -> float:
        """Count a frame; returns current fps (500ms windows like the
        reference)."""
        self._frames += 1
        now = time.perf_counter()
        elapsed = now - self._window_start
        if elapsed > self.window:
            self.fps = self._frames / elapsed
            self._window_start = now
            self._frames = 0
        return self.fps

    def ms_per_pass(self) -> dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1) * 1000.0
                for k in self.totals}

    def mrays_per_s(self, rays_per_frame: float) -> float:
        return rays_per_frame * self.fps / 1e6

    def report(self) -> str:
        lines = [f"fps={self.fps:.1f}"]
        for k, v in sorted(self.ms_per_pass().items()):
            lines.append(f"  {k}: {v:.2f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler over the block (host ops, and the device's kernels
    when CUDA is available), written as a Chrome trace
    `<log_dir>/trace.json` (open it in chrome://tracing or Perfetto).
    Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def enable_nan_debugging():
    """Debug-mode NaN/Inf guard (the build's counterpart of the reference's
    nonexistent sanitizers, SURVEY §5): every frame's display and history
    state is checked, and the first NaN or Inf raises FloatingPointError
    (utils.debug.set_debug)."""
    from .debug import set_debug

    set_debug(True)
