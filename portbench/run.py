"""Run one cell of BENCHMARK.json on the CUDA card and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up builds the cell's configuration
(scene, stand-in assets, renderer), warms it up until the pipeline is
full, and the window then runs the cell's traffic mix, drawn from the
seed, for
--seconds: the viewer loop (traffic "loop": "viewer"; io.update, then
render_frame_u8, one viewer in a closed loop) or the frame server with
one HTTP viewer in a process of its own ("served"). The harness's clock
goes to every call on the engine's fly camera (program.Session). After
the window every render call's camera pose and the kept frames are
compared with the reference (check.py). --trace 1 runs
the same window with torch.profiler over a stretch of it (the viewer:
`trace_frames` more frames after it; the frame server: `trace_seconds`
from its middle) and reports the per-layer metrics instead of the
end-to-end ones.

The last line of stdout is one JSON object (correct, attempted, failed,
metrics, device, with --trace 1 breakdown, and last, checks: each number
compared with its limit); the checks are also the last lines of stderr.
Exits 2 without a CUDA card (or with fewer than the cell asks for), and 3
if a module of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import base64  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

from . import check, png, spec, traffic  # noqa: E402
from . import trace as tr  # noqa: E402
from .program import Session  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "flexlight_tpu")
GIB = float(1 << 30)


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, each compared whole (flexlight_tpu_torch is not
    flexlight_tpu)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = os.path.join(spec.ROOT, "build", "portbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)


def viewer_window(session, events, seconds, points, trace_frames, dev) -> dict:
    """One viewer in a closed loop: each iteration applies the events that
    are due, integrates the held keys at the harness's clock and renders.
    A delivery is a frame render_frame_u8 returns. With `trace_frames`, that
    many more frames of the same walk follow the window under the
    profiler, and the last of them is kept too. The profiler's start is
    left out of the harness's clock, so the held key does not carry the
    camera through it."""
    _sync(dev)
    t0 = time.perf_counter()
    t_end = t0 + seconds
    marks = [t0 + p * seconds for p in points]
    deliveries, kept, last = [], [], None
    state = {"next": 0, "paused": 0.0}

    def step():
        now_ms = (time.perf_counter() - state["paused"]) * 1000.0
        while state["next"] < len(events) and t0 * 1000.0 + events[state["next"]][0] <= now_ms:
            session.apply(events[state["next"]], now_ms)
            state["next"] += 1
        session.io.update(now_ms)
        return session.render_frame_u8()

    while time.perf_counter() < t_end:
        frame = step()
        t = time.perf_counter()
        if t > t_end:
            break
        deliveries.append(t)
        last = (session.frame_of_call(len(session.poses) - 1), frame)
        while len(kept) < len(marks) and t >= marks[len(kept)]:
            kept.append(last)
    if last is not None:
        kept += [last] * (len(marks) - len(kept))
    out = {"t0": t0, "t_end": t_end, "deliveries": deliveries, "kept": kept, "failed": 0}
    if trace_frames:
        pause = time.perf_counter()
        _sync(dev)
        prof = tr.profiler()
        prof.start()
        start, calls = time.perf_counter(), len(session.poses)
        state["paused"] += start - pause
        for _ in range(trace_frames):
            frame = step()
        _sync(dev)
        wall = time.perf_counter() - start
        prof.stop()
        kept.append((session.frame_of_call(len(session.poses) - 1), frame))
        out["trace"] = tr.summarize(prof, len(session.poses) - calls, wall)
    return out


def served_window(session, events, seconds, points, trace_seconds, dev) -> dict:
    """The frame server on 127.0.0.1 (port 0) and one viewer in its own
    process (client.py), looping as the viewer page does. A delivery is a
    PNG unlike the one before it. With `trace_seconds`, the
    profiler starts at the window's middle and records that long; the
    frame the renderer returned last in that stretch is kept too."""
    session.keep_frames()
    server = session.server()
    server.start()
    proc = subprocess.Popen([sys.executable, "-m", "portbench.client"], cwd=spec.ROOT,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        proc.stdin.write(json.dumps({"host": server.host, "port": server.port,
                                     "seconds": seconds, "events": events,
                                     "points": points}))
        proc.stdin.close()
        t0 = json.loads(proc.stdout.readline())["window_start"]
        prof = None
        if trace_seconds:
            time.sleep(max(t0 + seconds / 2 - time.perf_counter(), 0.0))
            trace_start = time.perf_counter()
            prof = tr.profiler()
            prof.start()
            stretch = (time.perf_counter(), len(session.poses))
            time.sleep(trace_seconds)
            calls = len(session.poses)
            wall = time.perf_counter() - stretch[0]
            prof.stop()
        result = json.loads(proc.stdout.readline())
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        server.stop()
    kept, failed = [], result["failed"]
    for data in result["kept"]:
        frame = png.decode(base64.b64decode(data))
        call = session.call_of(frame)
        if call is None:   # a PNG of no frame the renderer returned
            failed += 1
            continue
        kept.append((session.frame_of_call(call), frame))
    out = {"t0": t0, "t_end": result["window_end"], "deliveries": result["deliveries"],
           "kept": kept, "failed": failed}
    if prof is not None:
        kept.append((session.frame_of_call(calls - 1), session.frames[calls - 1]))
        out["trace"] = tr.summarize(prof, calls - stretch[1], wall)
        out["trace_start"] = trace_start
    return out


def end_to_end(window: dict, seconds: float, peak_bytes: int, setup_s: float) -> dict:
    deliveries = window["deliveries"]
    gaps = np.diff(np.asarray(deliveries)) * 1000.0
    return {"frame_ms": seconds * 1000.0 / max(len(deliveries), 1),
            "frame_p95_ms": float(np.percentile(gaps, 95)) if len(gaps) else None,
            "peak_mem_gib": peak_bytes / GIB,
            "setup_s": setup_s}


def spans(window: dict, records, clock_offset: float) -> dict:
    """Host spans of the window before its traced stretch: the served
    frame's ms (window over deliveries) and the renderer's own mean ms a
    frame (its metrics ring, utils.metrics.frame_record)."""
    t0 = window["t0"]
    t1 = window.get("trace_start", window["t_end"])
    n = sum(1 for t in window["deliveries"] if t <= t1)
    own = [ms for ts, ms in records if t0 <= ts - clock_offset <= t1]
    return {"delivered_frame_ms": (t1 - t0) * 1000.0 / n if n else None,
            "renderer_frame_ms": float(np.mean(own)) if own else None}


def drive(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, dev, tmp: str) -> dict:
    """Set up, warm up and run the window; then free the program's state.
    Returns the window (deliveries, kept frames, trace) with the record of
    the viewer's calls and every render call's pose (Session.record), the
    peak device memory, the renderer's spans and scheme."""
    import torch

    session = Session(cfg, dev, tmp)
    events = traffic.schedule(mix, seed, (seconds + 60.0) * 1000.0)
    points = traffic.sample_points(seed, cfg["check"]["frames"])
    session.warm_up(mix["warmup_frames"])
    if mix["loop"] == "served":
        window = served_window(session, events, seconds, points,
                               mix["trace_seconds"] if trace else 0.0, dev)
    else:
        window = viewer_window(session, events, seconds, points,
                               mix["trace_frames"] if trace else 0, dev)
    _sync(dev)
    cuda = dev.type == "cuda"
    window.update(peak=torch.cuda.max_memory_allocated(dev) if cuda else 0,
                  records=session.renderer_records(), scheme=session.scheme(),
                  record=session.record())
    session.close()
    del session
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return window


def run_cell(bench: dict, cell: dict, cfg: dict, mix: dict, seed: int, seconds: float,
             trace: bool, device: str, start: float = PROCESS_START) -> dict:
    """Set up, warm up, run the window, compare; returns the result line
    (device numbers are read only on a CUDA device)."""
    import torch

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        window = drive(cfg, mix, seed, seconds, trace, dev, tmp)
        cmp = check.compare(cfg, dev, tmp, window["record"], window["kept"], count=trace)
    peak, records, scheme = window["peak"], window["records"], window["scheme"]
    limit = cfg["check"]["limit_values_off_pct"]
    readings = cmp["readings"]
    worst = max(readings) if readings else 100.0
    failed = window["failed"] + sum(1 for r in readings if r > limit) + cmp["poses_off"]
    correct = bool(readings) and failed == 0
    wanted = spec.metrics_of(bench, cell["name"], trace)
    if trace:
        run = SimpleNamespace(
            scheme=scheme, trace=window.get("trace"), shape=cmp["shape"], counts=cmp["counts"],
            passes=cmp["passes"],
            spans=spans(window, records, time.time() - time.perf_counter()))
        values = {m["name"]: spec.metric_reader(m["name"])(run) for m in wanted}
    else:
        values = end_to_end(window, seconds, peak, window["t0"] - start)
        if not cuda:   # a rehearsal: no device number under a device metric's name
            values["peak_mem_gib"] = None
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in wanted if values.get(m["name"]) is not None}
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    result = {"correct": correct, "attempted": len(window["deliveries"]), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": name,
                         "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}}
    if trace and window.get("trace"):
        for line in tr.by_kernel(window["trace"]):
            print(line, file=sys.stderr)
        result["device"]["busy_s"] = window["trace"]["busy_s"]
        result["device"]["window_s"] = window["trace"]["wall_s"]
        result["breakdown"] = tr.breakdown(window["trace"])
    result["checks"] = {"poses_off": {"value": cmp["poses_off"], "limit": 0},
                        "frame_values_off_pct": {"value": worst, "limit": limit},
                        "failed_requests": {"value": window["failed"], "limit": 0}}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, cell, cfg, mix, args.seed, args.seconds, bool(args.trace), "cuda:0")
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or of the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
