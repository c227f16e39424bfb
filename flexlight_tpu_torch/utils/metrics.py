"""Structured per-frame metrics (SURVEY §5 "metrics/observability").

The port's own copy of flexlight_tpu/utils/metrics.py (flexlight_tpu_torch imports
nothing of the JAX package).

The reference exposes only a 500 ms-window FPS counter
(pathtracerWGL2.js:293-298) and ad-hoc console logging; this subsystem is
the engine's structured counterpart: every rendered frame appends one
flat dict (timestamp, frame index, wall ms, fps window, resolution,
traversal scheme, config knobs) to a bounded in-memory ring, optionally
streamed to disk as JSON lines for external scraping.

Usage:
    renderer.metrics.attach("frames.jsonl")   # optional JSONL sink
    renderer.render_frame()
    renderer.metrics.last                     # most recent record
    renderer.metrics.records                  # bounded history
"""

from __future__ import annotations

import json
import time
from collections import deque


class FrameMetrics:
    """Bounded ring of per-frame metric records with an optional JSONL
    sink. Records are plain dicts so callers can extend them freely."""

    # 2048 records: a minute of frames at 30 fps, so a reader after a
    # minute-long run (the benchmark's served cell) still finds its start
    def __init__(self, capacity: int = 2048):
        self.records = deque(maxlen=capacity)
        self._fh = None

    @property
    def last(self) -> dict | None:
        return self.records[-1] if self.records else None

    def attach(self, jsonl_path) -> "FrameMetrics":
        """Stream every subsequent record to `jsonl_path` (one JSON object
        per line, append mode). Returns self for chaining."""
        self.detach()
        self._fh = open(jsonl_path, "a")
        return self

    def detach(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def record(self, **fields) -> dict:
        rec = {"ts": time.time(), **fields}
        self.records.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec


def frame_record(renderer, frame_ms: float, **extra) -> dict:
    """Assemble the standard per-frame record from a renderer's public
    surface (shared by PathTracer / Rasterizer / Simple)."""
    config = renderer.config
    return renderer.metrics.record(
        renderer=renderer.type,
        frame=renderer._frame_count,
        frame_ms=round(frame_ms, 3),
        fps=round(renderer.fps, 2),
        width=renderer.width,
        height=renderer.height,
        samples_per_ray=config.samples_per_ray,
        max_reflections=config.max_reflections,
        temporal=bool(config.temporal),
        filter=bool(config.filter),
        antialiasing=config.antialiasing,
        **extra,
    )
