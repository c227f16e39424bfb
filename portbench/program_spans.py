"""The program's own spans, as the per-layer metrics that read them
(metrics/host_render_ms.py, host_post_ms.py, fetch_wait_ms.py,
encode_ms.py, served_share.py) take them: the spans that
flexlight_tpu_torch.utils.timing kept while the profiler recorded the
traced stretch. The one module of the benchmark besides program.py and the
scene files that imports the program, and of it only utils.timing."""


def recorded():
    """The program's kept spans, or None where it has no recorder."""
    try:
        from flexlight_tpu_torch.utils.timing import recorded as program_recorded
    except ImportError:
        return None
    return program_recorded()


def ms_a_frame(name: str):
    """Host ms a complete frame (a kept span fl.frame) inside the spans
    `name` of that frame; None where no frame was kept."""
    spans = recorded()
    if spans is None:
        return None
    frames = [s.trace for s in spans if s.name == "fl.frame"]
    if not frames:
        return None
    traces = set(frames)
    ns = sum(s.end_ns - s.start_ns for s in spans if s.name == name and s.trace in traces)
    return ns / 1e6 / len(frames)


def seqs(name: str):
    """The frame numbers (attribute seq) of the kept spans `name`, or None
    where the program keeps no spans."""
    spans = recorded()
    if spans is None:
        return None
    return {s.attrs["seq"] for s in spans if s.name == name}
