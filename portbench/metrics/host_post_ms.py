"""The host's ms a frame inside the program's span fl.post
(models/pathtracer.py postprocess_mrt: temporal, the filter chain, FXAA /
TAA), over the complete frames the program kept in the traced stretch
(program_spans.py)."""

from portbench import program_spans


def read(run):
    return program_spans.ms_a_frame("fl.post")
