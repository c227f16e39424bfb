"""The device trace of a stretch of frames: torch.profiler over the
stretch, reduced to what the per-layer metrics and the result's
`breakdown` read (the reading and summing of tools/profile_frame.py)."""

from __future__ import annotations

from collections import defaultdict

# CUDA function names of the program's own kernels (csrc/*.cu), by group
PORT_KERNELS = ("fl_closest_hit", "fl_any_hit", "fl_sparse_flags", "fl_sparse_key",
                "fl_sparse_closest", "fl_sparse_any", "fl_sp_pre", "fl_sp_post",
                "fl_sp_live_list", "fl_fused_frame", "fl_shade", "fl_alive_list",
                "fl_interp_shade", "fl_disc_first", "fl_disc_second", "fl_disc_final",
                "fl_fxaa")
NAME_CHARS = 120


def is_port_kernel(name: str) -> bool:
    return any(prefix in name for prefix in PORT_KERNELS)


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _union(intervals):
    """Merged [start, end] segments of intervals sorted by start."""
    merged = []
    for start, end in intervals:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def summarize(prof, frames: int, wall_s: float) -> dict:
    """{"frames", "wall_s", "busy_s" (the union of kernel intervals),
    "kernels": {name: [launches, device seconds]}, "idle_gaps": the ten
    longest gaps between device work, each named by the innermost host op
    running at its middle}."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.events():
        span = (ev.time_range.start, ev.time_range.end, ev.name)
        (device if ev.device_type == DeviceType.CUDA else host).append(span)
    device.sort()
    kernels = defaultdict(lambda: [0, 0.0])
    for start, end, name in device:
        k = kernels[name]
        k[0] += 1
        k[1] += (end - start) * 1e-6
    merged = _union([(s, e) for s, e, _ in device])
    busy_s = sum(e - s for s, e in merged) * 1e-6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)[:10]
    idle = []
    for length, start, end in gaps:
        mid = (start + end) / 2
        covering = [(e - s, name) for s, e, name in host if s <= mid <= e]
        label = min(covering)[1] if covering else "host outside torch ops"
        idle.append([label[:NAME_CHARS], length * 1e-6])
    return {"frames": frames, "wall_s": wall_s, "busy_s": busy_s,
            "kernels": {name: v for name, v in kernels.items()}, "idle_gaps": idle}


def device_seconds(trace: dict, names=None, port: bool | None = None) -> float:
    """Device seconds of the stretch's kernels whose names hold one of
    `names`, or of the program's own kernels (port=True) or of all others
    (port=False)."""
    total = 0.0
    for name, (_, seconds) in trace["kernels"].items():
        if names is not None and not any(n in name for n in names):
            continue
        if port is not None and is_port_kernel(name) != port:
            continue
        total += seconds
    return total


def breakdown(trace: dict) -> dict:
    ops = sorted(((name[:NAME_CHARS], s) for name, (_, s) in trace["kernels"].items()),
                 key=lambda x: -x[1])[:10]
    return {"device_ops": [list(x) for x in ops], "idle_gaps": trace["idle_gaps"]}


def by_kernel(trace: dict) -> list[str]:
    """One line per kernel of the program (and one for all of torch's):
    launches and device ms a frame over the stretch."""
    frames = max(trace["frames"], 1)
    rows = {prefix: [0, 0.0] for prefix in PORT_KERNELS}
    rows["torch"] = [0, 0.0]
    for name, (n, s) in trace["kernels"].items():
        key = next((p for p in PORT_KERNELS if p in name), "torch")
        rows[key][0] += n
        rows[key][1] += s
    return [f"trace {key}: {n / frames:g} launches, {s * 1000.0 / frames:.4f} ms a frame"
            for key, (n, s) in rows.items() if n]
