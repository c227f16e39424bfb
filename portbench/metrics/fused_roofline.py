"""csrc/fused.cu's share of its roofline, in percent: the least time a
frame's PRE, POST and live-list work could take (roofline.fused_bound_ms,
from the reference's live rays of the same frames) over those kernels'
device time a frame in the traced stretch."""

from portbench import roofline, trace

KERNELS = ("fl_sp_pre", "fl_sp_post", "fl_sp_live_list")


def read(run):
    t = run.trace
    if not t or not t["frames"] or not run.counts or not run.passes:
        return None
    ms = trace.device_seconds(t, names=KERNELS) * 1000.0 / t["frames"]
    if ms <= 0:
        return None
    counts = roofline.per_frame(run.counts, run.passes)
    return 100.0 * roofline.fused_bound_ms(counts, run.shape) / ms
