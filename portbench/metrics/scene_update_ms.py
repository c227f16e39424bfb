"""The host's ms a frame inside the program's span fl.scene.update
(models/base.py update_scene: the scene flattened, its BVH built, and its
buffers copied to the device anew), over the traced stretch. The update
runs in the scene's animation before the render call, outside fl.frame,
so the stretch's kept fl.scene.update spans are summed and divided by
its complete frames (spans fl.frame). None where the program keeps no
such span (a static scene, or a program without the span)."""

from portbench import program_spans

SPAN = "fl.scene.update"


def per_frame(value):
    """The sum of value(span) over the kept fl.scene.update spans, a
    complete frame; None where no frame or no such span was kept."""
    spans = program_spans.recorded()
    if not spans:
        return None
    frames = sum(1 for s in spans if s.name == "fl.frame")
    updates = [s for s in spans if s.name == SPAN]
    if not frames or not updates:
        return None
    return sum(value(s) for s in updates) / frames


def read(run):
    return per_frame(lambda s: (s.end_ns - s.start_ns) / 1e6)
