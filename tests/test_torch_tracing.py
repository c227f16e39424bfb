"""The port's recorder (flexlight_tpu_torch.utils.timing): spans are
kept only while a torch profiler records, nest per thread,
carry their thread, lie on the profiler's timeline as function-scope
records (never as user annotations, which the card's profiler mirrors
onto the device's timeline), and a CPU frame yields the span tree that
the benchmark's per-layer metrics read (portbench/metrics/host_*_ms.py,
fetch_wait_ms.py, through portbench/program_spans.py)."""

import threading

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

import flexlight_tpu_torch as port
from flexlight_tpu_torch.models.pathtracer import PathTracer
from flexlight_tpu_torch.scenes import stand_in_wood_texture, theater
from flexlight_tpu_torch.utils import timing


def _profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def clean_recorder():
    timing.reset()
    yield
    timing.reset()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_and_counters_are_off_without_a_profiler():
    first = timing.span("fl.a", i=1)
    assert first is timing.span("fl.b")       # one shared object, nothing made
    with first as s:
        s.set(x=1)
    assert not timing.tracing()
    assert timing.recorded() == []


def test_spans_nest_under_the_profiler():
    with _profile():
        with timing.span("fl.outer", k=1) as outer:
            with timing.span("fl.mid"):
                with timing.span("fl.inner", i=0):
                    pass
            with timing.span("fl.mid"):
                pass
            outer.set(done=True)
        with timing.span("fl.next"):
            pass
    with timing.span("fl.after"):        # the profiler stopped: not kept
        pass
    spans = timing.recorded()
    by = _by_name(spans)
    assert set(by) == {"fl.outer", "fl.mid", "fl.inner", "fl.next"}
    outer, = by["fl.outer"]
    inner, = by["fl.inner"]
    mids = by["fl.mid"]
    nxt, = by["fl.next"]
    assert outer.parent is None and outer.trace == outer.id
    assert outer.attrs == {"k": 1, "done": True} and inner.attrs == {"i": 0}
    assert [m.parent for m in mids] == [outer.id, outer.id]
    assert inner.parent == mids[0].id
    assert {s.trace for s in (inner, *mids)} == {outer.id}
    assert nxt.parent is None and nxt.trace == nxt.id != outer.id
    for child, parent in ((mids[0], outer), (mids[1], outer), (inner, mids[0])):
        assert parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns
    assert mids[0].end_ns <= mids[1].start_ns
    assert {s.thread for s in spans} == {threading.current_thread().name}


def test_a_span_is_kept_only_if_tracing_saw_it_begin_and_end():
    prof = _profile()
    with timing.span("fl.before"):
        prof.start()
        with timing.span("fl.inside"):
            pass
        with timing.span("fl.straddle"):
            prof.stop()
    inside, = timing.recorded()
    assert inside.name == "fl.inside" and inside.parent is None


def test_spans_of_a_second_thread_carry_that_thread():
    def work():
        with timing.span("fl.worker", n=2):
            with timing.span("fl.worker_inner"):
                pass

    with _profile():
        with timing.span("fl.main"):
            t = threading.Thread(target=work, name="flexlight-test-worker")
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    by = _by_name(timing.recorded())
    worker, = by["fl.worker"]
    inner, = by["fl.worker_inner"]
    main, = by["fl.main"]
    # the worker's nest is its own: the main thread's open span is no parent
    assert worker.thread == inner.thread == "flexlight-test-worker"
    assert worker.parent is None and inner.parent == worker.id
    assert main.thread == threading.current_thread().name


def test_threads_lose_no_count_and_no_span():
    """More threads than cores, switching as often as the interpreter
    allows: every span of every thread is kept, under an id of its own."""
    import os
    import sys

    threads, n = 2 * (os.cpu_count() or 4), 300
    interval = sys.getswitchinterval()

    def work():
        for i in range(n):
            with timing.span("fl.stress", i=i):
                pass

    sys.setswitchinterval(1e-6)
    try:
        with _profile():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    spans = timing.recorded()
    assert len(spans) == threads * n and len({s.id for s in spans}) == threads * n
    assert all(s.parent is None for s in spans)


def test_span_names_appear_in_the_profile_of_the_thread_that_started_it():
    with _profile() as prof:
        with timing.span("fl.outer"):
            with timing.span("fl.inner", i=3):
                torch.ones(64).cumsum(0)
    events = [ev for ev in prof.events() if ev.name.startswith("fl.")]
    assert sorted(ev.name for ev in events) == ["fl.inner", "fl.outer"]
    # function scope, not a user annotation: the card's profiler would mirror
    # a user annotation onto the device's timeline as device work
    assert not any(ev.is_user_annotation for ev in events)
    cumsum = [ev for ev in prof.events() if "cumsum" in ev.name]
    inner = next(ev for ev in events if ev.name == "fl.inner")
    assert cumsum and all(inner.time_range.start <= ev.time_range.start
                          and ev.time_range.end <= inner.time_range.end for ev in cumsum)


def test_tracing_follows_the_process_wide_profiler_flag():
    """Tracing reads torch's process-wide flag, which every thread sees; a
    torch that drops the flag fails here instead of turning tracing off."""
    seen = {}

    def look():
        seen["thread"] = timing.tracing()

    assert autograd_profiler._is_profiler_enabled is False
    with _profile():
        assert autograd_profiler._is_profiler_enabled is True
        assert timing.tracing()
        t = threading.Thread(target=look)
        t.start()
        t.join(timeout=30)
    assert seen == {"thread": True}
    assert autograd_profiler._is_profiler_enabled is False and not timing.tracing()


def _frame_tree(spans, frame):
    """{name: [spans]} of the spans of one frame's trace."""
    return _by_name([s for s in spans if s.trace == frame.trace and s is not frame])


@pytest.mark.parametrize("scheme", ["fused_split", "sparse"])
def test_a_frame_yields_the_span_tree(scheme):
    e = theater(stand_in_wood_texture(0), device="cpu")
    e.canvas = (24, 16)
    config = port.Config(temporal=True, temporal_samples=2, filter=True,
                         antialiasing="fxaa", max_reflections=2)
    tracer = PathTracer(24, 16, e.scene, e.camera, config, "cpu", scheme=scheme)
    tracer.render_frame_u8()
    with _profile():
        e.io.update(1000.0)
        tracer.render_frame_u8()
    spans = timing.recorded()
    frame, = [s for s in spans if s.name == "fl.frame"]
    inp, = [s for s in spans if s.name == "fl.input"]
    assert frame.parent is None and inp.parent is None and inp.trace != frame.trace
    assert frame.attrs == {"frame": 2, "scheme": scheme}
    tree = _frame_tree(spans, frame)
    assert set(tree) == {"fl.render_mrt", "fl.primary", "fl.bounce", "fl.mrt", "fl.post",
                         "fl.temporal", "fl.filter", "fl.aa", "fl.fetch", "fl.fetch_wait"}
    render, = tree["fl.render_mrt"]
    post, = tree["fl.post"]
    fetch, = tree["fl.fetch"]
    wait, = tree["fl.fetch_wait"]
    assert [s.parent for s in (render, post, fetch)] == [frame.id] * 3
    # fused_split: the frame inputs and PRE; the others: the camera rays and
    # the primary cast
    assert len(tree["fl.primary"]) == (2 if scheme == "fused_split" else 1)
    assert [s.attrs["i"] for s in tree["fl.bounce"]] == [0, 1]
    for name in ("fl.primary", "fl.bounce", "fl.mrt"):
        assert all(s.parent == render.id for s in tree[name])
    for name in ("fl.temporal", "fl.filter", "fl.aa"):
        assert all(s.parent == post.id for s in tree[name])
    assert wait.parent == fetch.id
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    for parent in (frame, render, post, fetch):
        children = [s for s in spans if s.parent == parent.id]
        assert children
        assert sum(s.end_ns - s.start_ns for s in children) <= parent.end_ns - parent.start_ns
