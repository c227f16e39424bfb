"""The path tracer's delivered frame on a scene whose geometry and lights
change every frame: the reference of a configuration whose `reference`
is "pathtracer_animated".

It is the path tracer's `Reference` (reference/renderers/pathtracer.py),
which puts the scene in a frame's state with the scene file's
`at(frame)` and then replaces only the transforms of its buffers. Here
each `at(frame)` is followed by the frozen copy's whole rebuild of the
scene buffers (`build_scene_buffers`), as the program's update_scene
rebuilds them before every frame, so a moved vertex or a filled light
slot reaches the frame. `shape()` reports the scene of the frames it
renders (frame 0's state), not the state before the first animation.
"""

from __future__ import annotations

from portbench.reference.frozen.ops.buffers import build_scene_buffers
from portbench.reference.renderers import pathtracer


class Reference(pathtracer.Reference):
    """`at(frame)` (never None here) puts `engine.scene` in the state of
    frame number `frame`."""

    def __init__(self, cfg: dict, engine, at, device):
        super().__init__(cfg, engine, at, device)
        self.scene = engine.scene
        self.scene_at = at
        self.at = self.rebuilt_at
        self.at(0)

    def rebuilt_at(self, frame: int):
        """The scene in the state of `frame`, and its buffers rebuilt."""
        self.scene_at(frame)
        self.buffers = build_scene_buffers(self.scene, self.buffers.geometry.device)
