"""Row 1's share of its roofline in the rasterizer's frame, in percent:
the least time a frame's dense casts (csrc/intersect.cu, closest hit a
layer and any hit a light and layer) could take (roofline.casts_bytes and
tests_ops, from the reference's live rays of the same frame) over those
kernels' device time a frame in the traced stretch."""

from portbench import roofline, trace

KERNELS = ("fl_closest_hit", "fl_any_hit")


def read(run):
    t = run.trace
    if not t or not t["frames"] or not run.counts or not run.passes:
        return None
    ms = trace.device_seconds(t, names=KERNELS) * 1000.0 / t["frames"]
    if ms <= 0:
        return None
    c = roofline.per_frame(run.counts, run.passes)
    return 100.0 * roofline.bound_ms(roofline.casts_bytes(c, run.shape["triangles"]),
                                     roofline.tests_ops(c)) / ms
