"""Observability utilities: phase timing, work accounting and traces.

The port of the JAX package's ``utils/diagnostics.py``:

* :class:`PhaseTimer`, an opt-in host-side wall-clock accumulator of named
  phases (the reference's ``@timeit_debug`` timers), copied as it is;
* :func:`cycle_work` — nnz-based work accounting per cycle, the quantity
  behind the Gnnz/s benchmark metric, copied as it is;
* :func:`profile_trace` — a ``torch.profiler`` trace of a block (CPU and,
  where there is a card, CUDA activity), written as a Chrome trace.  While
  a profiler records (this trace or any other) the device cycle
  (``models/device.py``) marks its phases with
  ``torch.profiler.record_function`` ranges under the names the JAX
  package's ``jax.named_scope`` annotations use (``L{lvl}/down``,
  ``L{lvl}/fused_tail``, ``coarse_solve``, ``L0/updown`` …); with no
  profiler recording the cycle opens no range.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch

__all__ = ["PhaseTimer", "cycle_work", "profile_trace", "phase_range"]


def phase_range(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler records; a no-op context otherwise (a range costs a dispatcher
    call even with no profiler listening)."""
    if not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


class PhaseTimer:
    """Opt-in accumulator for named setup/solve phases.

    >>> t = PhaseTimer()
    >>> with t.phase("strength"): ...
    >>> t.report()
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["phase                          total_s   calls"]
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<30} {tot:8.3f}  {self.counts[name]:6d}")
        return "\n".join(lines)


def cycle_work(ml, cycle: str = "V") -> int:
    """nnz touched by SpMV-class ops in one cycle (smoothers + residual +
    transfer operators), the work measure of the Gnnz/s benchmark.

    A symmetric-GS smoother sweep touches nnz(A) per direction; V visits
    each level once, W twice per recursion level (counted approximately as
    2^depth), F between the two.
    """
    total = 0
    visits = 1
    for level in ml.levels:
        total += visits * (4 * level.A.nnz + level.A.nnz + level.R.nnz + level.P.nnz)
        if cycle == "W":
            visits *= 2
    if ml.levels:
        total += ml.levels[0].A.nnz  # outer residual
    return total


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Wrap a block in a ``torch.profiler`` trace, written to
    ``logdir/trace.json`` (Chrome trace format; CUDA activity too where a
    card is present), the device cycle's phase ranges in it; yields the
    profiler, whose ``key_averages()`` sums the block by kernel and range."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
