"""The traced slice of a run: ``torch.profiler`` over a few seconds of the
window, reduced to the device's intervals, and the harness's own host
spans beside them on one clock.

The arithmetic is plain functions on lists of (start, end) seconds, so the
tests hold it on synthetic traces: the union of intervals (after
``frp_tpu_torch/utils/profiling.py::busy_ms``, keeping kernel, memcpy and
memset events and no ``record_function`` range), the idle gaps labelled by
the host spans open across them, and kernel time by name.
"""

from __future__ import annotations

import threading
import time

MARK = "perfbench.mark"


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def merge(intervals) -> list:
    """Sorted, disjoint union of (start, end) intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def union_length(intervals) -> float:
    return sum(b - a for a, b in merge(intervals))


def idle_share(intervals, lo: float, hi: float) -> float:
    """1 - (union of the device's intervals within [lo, hi]) / (hi - lo)."""
    return 1.0 - union_length(clip(intervals, lo, hi)) / (hi - lo)


def gaps(intervals, lo: float, hi: float) -> list:
    """The idle (start, end) stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in merge(clip(intervals, lo, hi)):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def label(gap, spans) -> str:
    """The names of the host spans (name, start, end) that overlap ``gap``
    most, joined by '+', ordered by overlap; "host idle" where none does."""
    a, b = gap
    over: dict = {}
    for name, s, e in spans:
        o = min(b, e) - max(a, s)
        if o > 0:
            over[name] = over.get(name, 0.0) + o
    if not over:
        return "host idle"
    return "+".join(n for n, _ in sorted(over.items(), key=lambda kv: -kv[1]))


def longest_gaps(intervals, spans, lo: float, hi: float, n: int = 10) -> list:
    """The ``n`` longest idle gaps of [lo, hi] as [label, seconds]."""
    g = sorted(gaps(intervals, lo, hi), key=lambda ab: ab[0] - ab[1])[:n]
    return [[label(x, spans), x[1] - x[0]] for x in g]


def by_name(events, n: int = 10) -> list:
    """[[name, seconds], ...] of the device events (name, start, end) with
    the most time, summed by name."""
    acc: dict = {}
    for name, a, b in events:
        acc[name] = acc.get(name, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]


class Spans:
    """Host spans (name, start, end) on ``time.perf_counter``'s clock, kept
    in memory; threads append their own."""

    def __init__(self):
        self.items: list = []
        self._lock = threading.Lock()

    def add(self, name: str, start: float, end: float) -> None:
        with self._lock:
            self.items.append((name, start, end))

    def between(self, lo: float, hi: float) -> list:
        with self._lock:
            return [s for s in self.items if s[2] > lo and s[1] < hi]


class DeviceTrace:
    """``torch.profiler`` over [start(), stop()]: the device's events as
    (name, start, end) seconds on ``time.perf_counter``'s clock, aligned by a
    marker range recorded at a known host time, read by ``collect()``."""

    def __init__(self):
        self.prof = None
        self.lo = self.hi = None
        self.events: list = []
        self._mark_t = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        with torch.profiler.record_function(MARK):
            self._mark_t = time.perf_counter()
        self.lo = time.perf_counter()

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.hi = time.perf_counter()
        self.prof.stop()

    def collect(self) -> None:
        """Read the events, once the run no longer needs the host."""
        import torch

        dev = torch.autograd.DeviceType.CUDA
        evs = self.prof.events()
        mark = next(e for e in evs if e.name == MARK and e.device_type != dev)
        offset = self._mark_t - mark.time_range.start / 1e6
        user = {e.name for e in evs if e.device_type != dev and
                getattr(e, "is_user_annotation", False)} | {MARK}
        self.events = sorted(
            (e.name, e.time_range.start / 1e6 + offset, e.time_range.end / 1e6 + offset)
            for e in evs if e.device_type == dev and e.name not in user
            and not getattr(e, "is_user_annotation", False))

    @property
    def seconds(self) -> float:
        return self.hi - self.lo

    def kernels(self) -> list:
        """The device events that are kernels (no memcpy or memset)."""
        return [e for e in self.events
                if not e[0].startswith(("Memcpy", "Memset", "cudaMemcpy", "cudaMemset"))]


def device_busy_s(events, cuda) -> float:
    """The union, in seconds, of the device's events among a profile's raw
    events (``_KinetoEvent``: kernels, copies and memsets on device type
    ``cuda``; no user annotation)."""
    return union_length((e.start_ns() / 1e9, e.end_ns() / 1e9) for e in events
                        if e.device_type() == cuda and not e.is_user_annotation())


class BusyTrace:
    """``torch.profiler`` with the device's activity alone over
    [start(), stop()], so that no host operator is recorded and slowed;
    ``busy_s()`` is the union of the device's intervals."""

    def __init__(self):
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.prof.stop()

    def busy_s(self) -> float:
        import torch

        return device_busy_s(self.prof.profiler.kineto_results.events(),
                             torch.autograd.DeviceType.CUDA)
