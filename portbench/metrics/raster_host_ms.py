"""The host's ms a frame inside the program's span fl.raster
(models/rasterizer.py, around a frame's raster_frame): the camera rays,
each layer's cast and shading with its shadow casts, the blend and FXAA,
as the host enqueues them (and waits inside them), over the complete
frames (spans fl.frame) the program kept in the traced stretch
(program_spans.py). None where the program keeps no such span."""

from portbench import program_spans

SPAN = "fl.raster"


def read(run):
    return raster_ms(SPAN)


def raster_ms(name: str):
    """program_spans.ms_a_frame(name), or None where no span `name` was
    kept (a program without the rasterizer's spans)."""
    spans = program_spans.recorded()
    if not spans or not any(s.name == name for s in spans):
        return None
    return program_spans.ms_a_frame(name)
