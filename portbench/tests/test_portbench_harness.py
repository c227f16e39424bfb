"""The harness on the CPU: each cell's loop at a tiny size (the viewer
loop, and the frame server with its client process), the result line's
keys, the JAX-free check, the input schedules and the metric readers."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench import run, spec, traffic
from portbench.tests.cells import rehearse

CONTRACT = {"correct", "attempted", "failed", "metrics", "device"}
ROOT = spec.ROOT


@pytest.mark.parametrize("workload, seconds", [("theater-1080p-viewer", 3.0),
                                               ("theater-1080p-served", 4.0)])
def test_tiny_cell_runs_and_is_correct(workload, seconds):
    """The served loop is the slower on the CPU: the client polls without
    a pause, as the viewer page does, and its requests' handler threads
    take the interpreter lock from the render thread."""
    res = rehearse(workload, seconds=seconds)
    assert set(res) == CONTRACT | {"checks"}
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert res["device"]["platform"] == "cpu"
    # a CPU run writes no device number under a device metric's name; a
    # tail needs two deliveries, which the starved server may not make
    tail = {"frame_p95_ms"} if res["attempted"] >= 2 else set()
    assert set(res["metrics"]) == {"frame_ms", "setup_s"} | tail
    assert tail or workload.endswith("served")
    assert res["checks"]["frame_values_off_pct"]["value"] == 0.0
    assert res["checks"]["poses_off"]["value"] == 0


def test_tiny_trace_run_reports_per_layer_keys():
    res = rehearse("theater-1080p-served", trace=True)
    assert set(res) == CONTRACT | {"checks", "breakdown"}
    assert list(res)[-1] == "checks"
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    # no device on the CPU: only the host span of the frame server is read
    assert set(res["metrics"]) <= {"server_self_ms"}


def test_main_without_a_card_prints_no_result():
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "theater-1080p-viewer", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                                            "HOME": "/nonexistent"})
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


@pytest.mark.parametrize("modules, found", [
    (["flexlight_tpu_torch", "flexlight_tpu_torch.ops.fused", "torch"], []),
    (["flexlight_tpu", "flexlight_tpu_torch"], ["flexlight_tpu"]),
    (["flexlight_tpu.ops.fused"], ["flexlight_tpu"]),
    (["jax.numpy", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flaxen", "flexlight_tpu_extra"], []),
])
def test_forbidden_modules_compare_top_level_names_whole(modules, found):
    assert run.forbidden_modules(modules) == found


def test_harness_and_reference_import_no_jax():
    code = ("import sys, portbench.run, portbench.check, portbench.control; "
            "from portbench import spec; spec.part('reference/renderers', 'pathtracer'); "
            "import portbench.run as r; print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip() == "[]"


SCENES = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "portbench", "scenes"))
                if f.endswith(".py"))


def test_reference_imports_nothing_of_the_program():
    """Every scene file's reference side, and the reference renderer, on
    a tiny frame: no module of the program (nor JAX) is loaded."""
    code = ("import sys, tempfile, torch; from portbench import check, spec\n"
            "bench = spec.load_benchmark()\n"
            "cfg = spec.config(bench, bench['configs'][0]['name'])\n"
            "cfg['width'], cfg['height'] = 12, 8\n"
            f"for scene in {SCENES!r}:\n"
            "    cfg['scene'] = scene\n"
            "    engine, ref = check.reference(cfg, 'cpu', tempfile.mkdtemp())\n"
            "    ref.display_u8([(0.0, 1.0, 0.0, 0.0, 0.0)], [0])\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'flexlight_tpu_torch', 'flexlight_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip() == "[]"
    assert {"theater", "dragon"} <= set(SCENES)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11])
def test_schedule_holds_a_key_at_every_moment_and_pairs_moves(seed):
    mix = spec.traffic("viewer-walk")
    events = traffic.schedule(mix, seed, 20000.0)
    assert events == traffic.schedule(mix, seed, 20000.0)
    held, t_prev = set(), 0.0
    for t, kind, *args in events:
        assert t >= t_prev
        if t > t_prev and t < 20000.0:
            assert len(held) == 1, (t, held)
        t_prev = t
        if kind == "keydown":
            held.add(args[0])
        elif kind == "keyup":
            held.discard(args[0])
    moves = [e for e in events if e[1] == "mouse"]
    assert len(moves) % 2 == 0
    assert abs(sum(e[2] for e in moves)) < 1e-9 and abs(sum(e[3] for e in moves)) < 1e-9
    lo, hi = mix["hold_ms"]
    downs = {}
    for t, kind, *args in events:
        if kind == "keydown":
            downs[args[0]] = t
        elif kind == "keyup":
            assert lo <= t - downs.pop(args[0]) <= hi


def test_sample_points_end_at_the_window_end():
    pts = traffic.sample_points(2 ** 31 + 3, 4)
    assert pts == sorted(pts) and pts[-1] == 1.0 and all(0.2 <= p < 0.95 for p in pts[:-1])
    assert pts == traffic.sample_points(2 ** 31 + 3, 4)


def test_every_metric_and_file_of_the_benchmark_is_found():
    bench = spec.load_benchmark()
    for c in bench["configs"]:
        cfg = spec.config(bench, c["name"])
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for w in bench["workloads"]:
        spec.traffic(w["traffic"])
        e2e = {m["name"] for m in spec.metrics_of(bench, w["name"], False)}
        assert {"setup_s", "frame_ms"} <= e2e
        per_layer = spec.metrics_of(bench, w["name"], True)
        assert per_layer
        for m in per_layer:
            assert callable(spec.metric_reader(m["name"]))
    json.dumps(bench)


def _trace(kernels, frames=10, wall_s=1.0, busy_s=0.6):
    return {"frames": frames, "wall_s": wall_s, "busy_s": busy_s, "kernels": kernels,
            "idle_gaps": []}


def test_metric_readers_on_a_made_up_trace():
    from types import SimpleNamespace

    kernels = {"fl_sp_pre_kernel": [10, 0.002], "fl_sp_post_kernel": [50, 0.020],
               "void at::native::elementwise_kernel<...>": [1000, 0.100]}
    counts = {"closest_live": [2_000_000, 1_000_000], "closest_hits": [1_500_000, 500_000],
              "any_live": [1_500_000]}
    shape = {"pixels": 2_073_600, "triangles": 20, "lights": 9, "texture_bytes": 786_432}
    r = SimpleNamespace(trace=_trace(kernels), counts=counts, passes=1, shape=shape,
                        spans={"delivered_frame_ms": 90.0, "renderer_frame_ms": 30.0})
    read = {n: spec.metric_reader(n)(r) for n in (
        "launches_per_frame", "glue_ms", "device_busy_ms", "device_idle_share",
        "fused_roofline", "sparse_roofline", "server_self_ms")}
    assert read["launches_per_frame"] == 106.0
    assert read["glue_ms"] == pytest.approx(10.0)
    assert read["device_busy_ms"] == pytest.approx(60.0)
    assert read["device_idle_share"] == pytest.approx(40.0)
    assert read["server_self_ms"] == pytest.approx(60.0)
    assert read["sparse_roofline"] is None      # no sparse kernel ran: nothing to read
    assert 0.0 < read["fused_roofline"] < 100.0
    # nothing to read: None, never 0
    empty = SimpleNamespace(trace=None, counts=None, passes=0, shape=shape,
                            spans={"delivered_frame_ms": None, "renderer_frame_ms": None})
    for n in read:
        assert spec.metric_reader(n)(empty) is None
