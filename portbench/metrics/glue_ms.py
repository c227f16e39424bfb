"""Device ms a frame of every kernel that is not one of the program's own
(csrc/, names fl_*): the torch glue around them."""

from portbench import trace


def read(run):
    t = run.trace
    if not t or not t["frames"] or not t["kernels"]:
        return None
    return trace.device_seconds(t, port=False) * 1000.0 / t["frames"]
