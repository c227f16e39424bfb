"""The share of the frame server's encodes that a client received, in
percent: 100 x the frames (attribute seq) of the program's spans
fl.serve.send that are also frames of its spans fl.serve.encode, over
those encodes, both kept in the traced stretch (serve.py;
program_spans.py). A frame encoded just before the stretch ends and sent
after it counts as not received. None where the program keeps no spans or
encoded nothing."""

from portbench import program_spans


def read(run):
    encoded = program_spans.seqs("fl.serve.encode")
    if not encoded:
        return None
    return 100.0 * len(program_spans.seqs("fl.serve.send") & encoded) / len(encoded)
