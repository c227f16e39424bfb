"""csrc/sparse.cu's share of its roofline, in percent: the least time a
frame's worklist casts could take (roofline.sparse_bound_ms, from the
reference's live rays of the same frames) over the device time a frame of
the flags, key, closest-hit and any-hit kernels in the traced stretch."""

from portbench import roofline, trace

KERNELS = ("fl_sparse_flags", "fl_sparse_key", "fl_sparse_closest", "fl_sparse_any")


def read(run):
    t = run.trace
    if not t or not t["frames"] or not run.counts or not run.passes:
        return None
    ms = trace.device_seconds(t, names=KERNELS) * 1000.0 / t["frames"]
    if ms <= 0:
        return None
    counts = roofline.per_frame(run.counts, run.passes)
    return 100.0 * roofline.sparse_bound_ms(counts, run.shape) / ms
