"""Device tracing and stage timers for the port's platform (port of
``frp_tpu/utils/profiling.py``): ``StageTimers`` as it is, and a
``DeviceTracer`` built on ``torch.profiler``, which writes a Chrome trace
(``trace.json``, the card's kernels and copies beside the host's ops) where
the JAX package writes a ``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import threading
import time
from collections import defaultdict

import torch

from frp_tpu_torch.utils.logger import get_logger

logger = get_logger("frp.utils.profiling")


class StageTimers:
    """Cheap named wall-clock accumulators (host-side view of stage costs)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._acc: dict[str, list] = defaultdict(lambda: [0, 0.0])

    @contextlib.contextmanager
    def track(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                entry = self._acc[name]
                entry[0] += 1
                entry[1] += dt

    def summary(self) -> dict:
        with self._lock:
            return {
                name: {
                    "calls": count,
                    "total_s": round(total, 4),
                    "mean_ms": round(total / max(count, 1) * 1000, 3),
                }
                for name, (count, total) in self._acc.items()
            }

    def reset(self):
        with self._lock:
            self._acc.clear()


class DeviceTracer:
    """torch.profiler trace sessions (one at a time): host ops, and the
    card's kernels and copies where there is a card, as a Chrome trace
    ``trace.json`` in a directory of its own under ``trace_dir``."""

    def __init__(self, trace_dir: str = "data/traces"):
        self.trace_dir = trace_dir
        self._lock = threading.Lock()
        self._active: tuple[str, torch.profiler.profile] | None = None

    def start(self, label: str = "trace") -> dict:
        with self._lock:
            if self._active is not None:
                return {"success": False, "message": "trace already running"}
            path = os.path.join(self.trace_dir, f"{label}_{int(time.time())}")
            os.makedirs(path, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            try:
                prof.start()
            except Exception as e:  # the route reports it; serving goes on
                logger.exception("trace start failed")
                return {"success": False, "message": str(e)}
            self._active = (path, prof)
            return {"success": True, "trace_dir": path}

    def stop(self) -> dict:
        with self._lock:
            if self._active is None:
                return {"success": False, "message": "no trace running"}
            path, prof = self._active
            self._active = None
            try:
                prof.stop()
                prof.export_chrome_trace(os.path.join(path, "trace.json"))
            except Exception as e:  # the route reports it; serving goes on
                logger.exception("trace stop failed")
                return {"success": False, "message": str(e)}
            return {"success": True, "trace_dir": path}

    @contextlib.contextmanager
    def annotate(self, name: str):
        """Named region visible in the trace."""
        with torch.profiler.record_function(name):
            yield


def busy_ms(fn, n: int, top: int = 4) -> tuple[float | None, list]:
    """Device-busy ms a call over n calls of fn from a torch.profiler trace
    (the union of the card's kernel and copy intervals), and the `top`
    kernels by device ms a call, with their share of the busy time; (None,
    []) when the trace holds no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    # the optimizer's record_function ranges appear on the device's timeline
    # too, spanning its kernels and the gaps between them: not device work
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.name.startswith("Optimizer.")]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    if not spans:
        return None, []
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    busy += hi - lo
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.end - e.time_range.start
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return busy / 1e3 / n, [(name[:48], t / 1e3 / n, t / busy) for name, t in ranked]


def gpu_name_and_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (the first card's)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]
