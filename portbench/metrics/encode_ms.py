"""The frame server's ms a frame in the program's span fl.serve.encode
(serve.py, the PNG encode on the render thread), over the encodes the
program kept in the traced stretch (program_spans.py). None where the
program keeps no spans or encoded nothing."""

from portbench import program_spans


def read(run):
    spans = program_spans.recorded()
    if spans is None:
        return None
    ns = [s.end_ns - s.start_ns for s in spans if s.name == "fl.serve.encode"]
    return sum(ns) / 1e6 / len(ns) if ns else None
