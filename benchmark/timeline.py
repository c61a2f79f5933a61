"""The traced window: device intervals and host spans from `torch.profiler`,
and the arithmetic every per-layer reader shares.

Busy time is the union of the device's intervals (kernels, copies,
memsets) inside the window, so work that overlaps (a copy on a side stream
beside a kernel) counts once. An idle gap is a stretch of the window that
no device interval covers; it is named by what the host was doing at its
middle: the innermost host event (an operator, a runtime call or one of
the harness's spans) that covers it, else "host python".
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "bench.window"
LABELLED_GAPS = 400      # the longest gaps named one by one
TOP = 10


@dataclass
class Trace:
    """What the per-layer readers read: the window's bounds (ns), its
    device intervals (name, start, end), the harness's counters and the
    shapes the driver ran (`work`)."""
    start: int
    end: int
    device: list
    host: list
    work: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-9

    def busy_intervals(self) -> list:
        """The union of the device intervals, clipped to the window."""
        spans = sorted((max(s, self.start), min(e, self.end))
                       for _, s, e in self.device if e > self.start
                       and s < self.end)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1][1] = e
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernel_seconds(self, *substrings: str) -> tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds any
        of `substrings`, inside the window."""
        total, n = 0, 0
        for name, s, e in self.device:
            if s >= self.start and e <= self.end and any(
                    sub in name for sub in substrings):
                total += e - s
                n += 1
        return total * 1e-9, n

    def device_ops(self) -> list:
        """The device operations that took most time: [[name, seconds]]."""
        by = {}
        for name, s, e in self.device:
            if s >= self.start and e <= self.end:
                by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name[:200], ns * 1e-9] for name, ns in top]

    def idle_gaps(self) -> list:
        """Idle time by what the host was doing: [[label, seconds]], the
        longest `LABELLED_GAPS` gaps named one by one, the rest summed as
        "short gaps"."""
        busy = self.busy_intervals()
        gaps, t = [], self.start
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            gaps.append((t, self.end))
        gaps.sort(key=lambda g: g[0] - g[1])
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by = {}
        for s, e in gaps[:LABELLED_GAPS]:
            label = _innermost(host, starts, (s + e) // 2)
            by[label] = by.get(label, 0) + (e - s)
        rest = sum(e - s for s, e in gaps[LABELLED_GAPS:])
        if rest:
            by["short gaps"] = by.get("short gaps", 0) + rest
        top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name[:200], ns * 1e-9] for name, ns in top]


def _innermost(host, starts, t) -> str:
    """The name of the latest-starting host event that covers `t`."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 4000, -1), -1):
        name, s, e = host[j]
        if e >= t:
            return name
    # a long outer span: the harness's own, which are few
    for name, s, e in reversed(host[:i]):
        if name.startswith("bench.") and e >= t:
            return name
    return "host python"


def _ns(e, which: str) -> int:
    if hasattr(e, f"{which}_ns"):
        return int(getattr(e, f"{which}_ns")())
    return int(getattr(e, f"{which}_us")() * 1000)


def from_profiler(prof, work: dict) -> Trace:
    """The `Trace` of a finished `torch.profiler.profile` whose window is
    the harness's `bench.window` span."""
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        name = e.name()
        on_device = "cuda" in str(e.device_type()).lower()
        if "annotation" in kind or name.startswith("bench."):
            # the harness's spans; their copies on the device's timeline
            # (gpu_user_annotation) are no device work
            if not on_device:
                if name == WINDOW_SPAN:
                    window = (start, end)
                else:
                    host.append((name, start, end))
        elif kind in DEVICE_ACTIVITIES or (not kind and on_device):
            device.append((name, start, end))
        elif name == WINDOW_SPAN:
            window = (start, end)
        else:
            host.append((name, start, end))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    return Trace(window[0], window[1], device, host, work)
