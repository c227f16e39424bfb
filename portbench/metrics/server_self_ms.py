"""The frame server's own ms a delivered frame (PNG encode, HTTP, the
render thread's waits): the window's ms per delivered PNG less the
renderer's mean host ms a frame, which its metrics ring records
(utils.metrics.frame_record), both over the window before the traced
stretch."""


def read(run):
    s = run.spans
    if s["delivered_frame_ms"] is None or s["renderer_frame_ms"] is None:
        return None
    return s["delivered_frame_ms"] - s["renderer_frame_ms"]
