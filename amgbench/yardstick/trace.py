"""Reduction of a ``torch.profiler`` trace of the measured window.

The device is busy while an operation runs on it: a kernel, a copy or a
memset.  Profiler ranges are not operations (a range's device row spans the
operations inside it), so busy time is the union of the operations'
intervals, and the idle share is 1 − busy / window (the arithmetic of
``profile_torch.py``, on the raw events rather than ``key_averages()``).
"""

import bisect
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW_RANGE = "amgbench/window"
NAME_CHARS = 120


@dataclass
class Trace:
    """Intervals in ns on the profiler's clock: ``window`` the harness's
    window range on the host; ``ops`` device operations (start, end, name,
    kind); ``annotations`` device rows of profiler ranges (start, end,
    name); ``host`` the host events of the thread that ran the window."""

    window: Tuple[int, int]
    ops: List[Tuple[int, int, str, str]] = field(default_factory=list)
    annotations: List[Tuple[int, int, str]] = field(default_factory=list)
    host: List[Tuple[int, int, str]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9


def _kind(e) -> str:
    """An event's activity type; older releases lack ``activity_type``."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    name, on_device = e.name(), e.device_type().name != "CPU"
    annotation = getattr(e, "is_user_annotation", lambda: False)()
    if on_device:
        if annotation:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if annotation:
        return "user_annotation"
    return "cuda_runtime" if name.startswith("cuda") else "cpu_op"


def _span(e) -> Tuple[int, int]:
    if hasattr(e, "start_ns"):
        start, dur = e.start_ns(), e.duration_ns()
    else:
        start, dur = e.start_us() * 1000, e.duration_us() * 1000
    return int(start), int(start + dur)


def from_profile(prof) -> Optional[Trace]:
    """The window's trace from a finished ``torch.profiler.profile``; None
    where the trace holds no window range."""
    events = prof.profiler.kineto_results.events()
    window, tid = None, None
    rows = []
    for e in events:
        kind = _kind(e)
        start, end = _span(e)
        name = e.name()
        if kind == "user_annotation" and name == WINDOW_RANGE:
            window, tid = (start, end), e.start_thread_id()
        rows.append((kind, start, end, name, e))
    if window is None:
        return None
    t = Trace(window=window)
    for kind, start, end, name, e in rows:
        if kind in DEVICE_OPS:
            t.ops.append((start, end, name, kind))
        elif kind == "gpu_user_annotation":
            t.annotations.append((start, end, name))
        elif kind in HOST_KINDS and e.start_thread_id() == tid:
            t.host.append((start, end, name))
    t.ops.sort()
    t.annotations.sort()
    t.host.sort(key=lambda ev: (ev[0], -ev[1]))  # an enclosing event before the ones it opens
    return t


def busy_intervals(t: Trace) -> List[Tuple[int, int]]:
    """The union of the device operations' intervals, clipped to the window."""
    lo, hi = t.window
    merged = []
    for start, end, _, _ in t.ops:
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def busy_s(t: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(t)) / 1e9


def idle_pct(t: Optional[Trace]) -> Optional[float]:
    """100 × (1 − busy / window); None where nothing ran on the device."""
    if t is None:
        return None
    busy = busy_s(t)
    if busy <= 0.0:
        return None
    return 100.0 * (1.0 - busy / t.window_s)


def range_device_s(t: Trace, keep) -> List[Tuple[str, float]]:
    """(name, seconds) for each device range whose name passes ``keep``: the
    summed time of the device operations that lie inside it."""
    starts = [op[0] for op in t.ops]
    out = []
    for start, end, name in t.annotations:
        if not keep(name):
            continue
        i = bisect.bisect_left(starts, start)
        total = 0
        while i < len(t.ops) and t.ops[i][0] < end:
            if t.ops[i][1] <= end:
                total += t.ops[i][1] - t.ops[i][0]
            i += 1
        out.append((name, total / 1e9))
    return out


def top_ops(t: Trace, k: int = 10) -> List[list]:
    """The ``k`` device operations that took the most time in the window,
    by name: [[name, seconds], ...]."""
    lo, hi = t.window
    totals = {}
    for s, e, name, _ in t.ops:
        if e > lo and s < hi:
            totals[name[:NAME_CHARS]] = totals.get(name[:NAME_CHARS], 0) + min(e, hi) - max(s, lo)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
    return [[name, ns / 1e9] for name, ns in ranked]


def idle_gaps(t: Trace, k: int = 10) -> List[list]:
    """The device's idle time in the window by what the host was doing: each
    gap between busy intervals is named by the innermost host event on the
    window's thread at the gap's midpoint ("host (no recorded op)" where
    none), and the ``k`` names with the most idle time are returned with
    their summed seconds."""
    lo, hi = t.window
    busy = busy_intervals(t)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    totals = {}
    stack, j = [], 0
    for a, b in gaps:
        mid = (a + b) // 2
        # host events on one thread nest: keep the chain of open events
        while j < len(t.host) and t.host[j][0] <= mid:
            while stack and stack[-1][1] < t.host[j][0]:
                stack.pop()
            stack.append(t.host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2][:NAME_CHARS] if stack else "host (no recorded op)"
        totals[name] = totals.get(name, 0) + (b - a)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
    return [[name, ns / 1e9] for name, ns in ranked]
