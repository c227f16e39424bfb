"""The host's ms a frame inside the program's span fl.render_mrt
(models/pathtracer.py frame_pipeline, around render_mrt): camera rays, the
casts and bounces, the render targets, as the host enqueues them (and
waits inside them), over the complete frames (spans fl.frame) the program
kept in the traced stretch (program_spans.py). None where the program
keeps no spans."""

from portbench import program_spans


def read(run):
    return program_spans.ms_a_frame("fl.render_mrt")
