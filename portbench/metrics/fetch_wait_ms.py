"""The host's ms a frame blocked in the program's span fl.fetch_wait: the
wait on the pipelined fetch's copy event (models/pathtracer.py
_HostCopy.result) or a synchronous copy (models/base.py _fetch). The part
of a frame in which the device sets the pace; over the complete frames
the program kept in the traced stretch (program_spans.py)."""

from portbench import program_spans


def read(run):
    return program_spans.ms_a_frame("fl.fetch_wait")
