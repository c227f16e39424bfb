"""The port's tracing utilities: spans inside the program on one
recorder, torch.profiler's Chrome-trace exporter, and the NaN / Inf guard
of the port's debug mode.

The reference only counts FPS over 500 ms windows (pathtracerWGL2.js:293-298).
Here the program marks where its work happens:

    with span("fl.bounce", i=i):     # a named stretch of host time
        ...

Tracing is on exactly while a torch profiler records in this process
(`torch.profiler.profile`, `profile_trace`): torch sets
`torch.autograd.profiler._is_profiler_enabled` from the profiler's start to
its stop, on every thread. Off, `span` reads that flag and returns a
shared object that does nothing. On, a span stamps `time.perf_counter_ns()`
at its enter and exit (the clock of `time.perf_counter`), and enters a
torch record function of its name, so that it lies on the profiler's
timeline beside the kernels in every thread the profiler records. It is a
function-scope record function (`torch._C._profiler._RecordFunctionFast`),
not a user annotation (`torch.profiler.record_function`): a user
annotation is mirrored onto the device's timeline as a
`gpu_user_annotation` event, which a trace reader would count as device
work. A span that tracing saw begin and end is kept, with the innermost
open span of its thread as its parent, in a deque of the newest `CAPACITY`
spans; `recorded()` returns them, `reset()` clears them. Variable data (a
bounce, a frame number) goes in a span's attributes, never in its name.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler


class Span(NamedTuple):
    """A kept span. `id` is its number in this process; `parent` the id of
    the innermost span open on the same thread at its enter (None at a
    root); `trace` the id of the root of its thread's nest, shared by
    every span under one root (a frame: one trace); `thread` the name of
    its thread."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    trace: int
    thread: str
    attrs: dict


CAPACITY = 1 << 16

_spans: deque[Span] = deque(maxlen=CAPACITY)
_lock = threading.Lock()
_local = threading.local()      # .stack: the thread's open spans
_ids = itertools.count(1)


def tracing() -> bool:
    """Whether a torch profiler records in this process."""
    return _profiler._is_profiler_enabled


class _Off:
    """The span of tracing off: does nothing, holds nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """A span entered with tracing on."""
    __slots__ = ("name", "attrs", "id", "parent", "trace", "start", "fn")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if top is None else top.id
        self.trace = self.id if top is None else top.trace
        stack.append(self)
        self.fn = torch._C._profiler._RecordFunctionFast(self.name)
        self.fn.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.fn.__exit__(*exc)
        _stack().pop()
        if tracing():
            kept = Span(self.name, self.start, end, self.id, self.parent, self.trace,
                        threading.current_thread().name, self.attrs)
            with _lock:
                _spans.append(kept)
        return False

    def set(self, **attrs):
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager over a named stretch of host time (kept while
    tracing is on at its enter and at its exit)."""
    if not tracing():
        return _OFF
    return _Open(name, attrs)


def recorded() -> list[Span]:
    """The kept spans, oldest first."""
    with _lock:
        return list(_spans)


def reset():
    with _lock:
        _spans.clear()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler over the block (host ops, the program's spans, and
    the device's kernels when CUDA is available), written as a Chrome
    trace `<log_dir>/trace.json` (open it in chrome://tracing or
    Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def enable_nan_debugging():
    """Debug-mode NaN/Inf guard (the build's counterpart of the reference's
    nonexistent sanitizers, SURVEY §5): every frame's display and history
    state is checked, and the first NaN or Inf raises FloatingPointError
    (utils.debug.set_debug)."""
    from .debug import set_debug

    set_debug(True)
