"""Tracing: a torch.profiler window and the program's own spans.

* `profile_trace(dir)`: a torch.profiler trace of the enclosed block (CPU
  and, on the card, CUDA activity), written to `dir` as a Chrome trace
  (viewable in ui.perfetto.dev).
* `span(name, device=False, **work)`: one named stretch of the program
  (a request, a step, a layer). It records only while a torch.profiler is
  active in the process (or inside `force_tracing()`); otherwise it costs
  one check of a flag and returns a shared null context. A recorded span
  is a host range of the profiler (a `RecordFunction` of function scope),
  so it sits in the profiler's trace on the device trace's clock, and a
  `Span` record in a bounded in-memory log:
  its id, its parent's, the id of its root span (the trace), its host
  interval in `time.time_ns()` (the clock of the profiler's host events),
  the `work` counts given at the call site and, with `device=True` on the
  card, a pair of CUDA events on the current stream, resolved to device
  milliseconds only when the records are read.
* `spans(start_ns, end_ns)`: the records whose host interval lies in the
  window; `clear_spans()` empties the log.

Spans nest per thread; the log keeps the last `MAX_SPANS` records. A
span is no `record_function` (user scope) range: for each of those that
launches device work the profiler adds a range on the device's timeline
(`gpu_user_annotation`), which a reader of the trace that cannot tell
event kinds apart (torch 2.11's kineto events have no `activity_type`)
would count as device work.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import os.path as osp
import threading
import time
from collections import deque

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_SPANS = 1 << 17


class _Open(threading.local):
    """This thread's open spans, innermost last."""

    def __init__(self):
        self.stack: list = []


_log: deque = deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_open = _Open()
_forced = False
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block into
    `log_dir/trace.json`."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(osp.join(log_dir, "trace.json"))


class Span:
    """One recorded span. `host_ms` is its host interval; `device_ms` the
    time the current CUDA stream took between its two events (None where
    it has none: off the card, or `device=False`)."""

    __slots__ = ("name", "id", "parent", "trace", "start_ns", "end_ns",
                 "work", "events", "device_ms")

    def __init__(self, name: str, sid: int, parent, trace: int, work: dict,
                 events):
        self.name, self.id, self.parent, self.trace = name, sid, parent, trace
        self.work, self.events = work, events
        self.start_ns = self.end_ns = 0
        self.device_ms = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class _Recording:
    __slots__ = ("span", "range")

    def __init__(self, name: str, device: bool, work: dict):
        parent = _open.stack[-1] if _open.stack else None
        sid = next(_ids)
        events = None
        if device and torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        self.span = Span(name, sid, parent.id if parent else None,
                         parent.trace if parent else sid, work, events)
        self.range = torch._C._profiler._RecordFunctionFast(name)

    def __enter__(self) -> Span:
        s = self.span
        s.start_ns = time.time_ns()
        self.range.__enter__()
        if s.events:
            s.events[0].record()
        _open.stack.append(s)
        _log.append(s)
        return s

    def __exit__(self, *exc) -> bool:
        s = self.span
        _open.stack.pop()
        if s.events:
            s.events[1].record()
        self.range.__exit__(*exc)
        s.end_ns = time.time_ns()
        return False


def span(name: str, *, device: bool = False, **work):
    """A context manager around one stretch of the program; entered, it
    gives its `Span` while tracing and None otherwise (see the module's
    docstring)."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Recording(name, device, work)


@contextlib.contextmanager
def force_tracing():
    """Record spans inside the block whether or not a profiler is active:
    for tests and for measuring what tracing costs."""
    global _forced
    was, _forced = _forced, True
    try:
        yield
    finally:
        _forced = was


def spans(start_ns: int, end_ns: int) -> list[Span]:
    """The records whose host interval lies in [start_ns, end_ns], in the
    order they started; device times are resolved here (waiting for their
    end events)."""
    out = [s for s in list(_log)
           if s.end_ns and start_ns <= s.start_ns and s.end_ns <= end_ns]
    for s in out:
        if s.events:
            s.events[1].synchronize()
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            s.events = None
    return out


def clear_spans() -> None:
    _log.clear()
