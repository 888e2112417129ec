"""Device tracing and stage timers for the port's platform (port of
``frp_tpu/utils/profiling.py``): ``StageTimers`` as it is, and a
``DeviceTracer`` built on ``torch.profiler``, which writes a Chrome trace
(``trace.json``, the card's kernels and copies beside the host's ops) where
the JAX package writes a ``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import os
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
