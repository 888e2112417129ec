"""Background camera health loop — reference ``backend/app/health_checks.py``:
poll every camera each interval, track consecutive_failures, exponential
backoff 10 s * 2^n capped at 1 h, persist healthy/last_seen to the cameras
collection. Probes the frame source directly instead of HTTP-ing our own
snapshot endpoint (the reference loops back through its own API).
"""

from __future__ import annotations

import threading
import time

from frp_tpu_torch.utils.logger import get_logger

logger = get_logger("frp.platform.health")

BACKOFF_BASE = 10.0
BACKOFF_CAP = 3600.0


class HealthMonitor:
    def __init__(self, registry, cameras_collection=None, interval: float = 30.0,
                 backoff_base: float = BACKOFF_BASE,
                 backoff_cap: float = BACKOFF_CAP,
                 request_timeout: float = 4.0,
                 concurrency: int = 1):
        self.registry = registry
        self._coll = cameras_collection
        self.interval = interval
        # CAMERA_BACKOFF_BASE / CAMERA_BACKOFF_MAX /
        # CAMERA_HEALTH_REQUEST_TIMEOUT / HEALTH_CONCURRENCY (reference
        # health_checks.py:29-35): request_timeout bounds one probe read
        # (RTSP-backed sources can block); concurrency > 1 probes due
        # cameras through a thread pool — one dead RTSP camera must not
        # serialize the whole fleet probe behind its timeout
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.request_timeout = request_timeout
        self.concurrency = max(1, int(concurrency))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._next_probe: dict[int, float] = {}
        # cam_id -> still-running probe thread: a wedged read() must not be
        # issued a SECOND concurrent read (cv2.VideoCapture is not
        # thread-safe), must not accumulate one leaked thread per tick, and
        # must not block interpreter exit (daemon threads, no executor)
        self._inflight: dict[int, threading.Thread] = {}
        self.probes = 0

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.probe_all()
            except Exception:
                logger.exception("health loop iteration failed")

    def probe_all(self) -> dict:
        now = time.time()
        results = {}
        due = []
        for cam in self.registry.all():
            if now < self._next_probe.get(cam.id, 0):
                results[cam.id] = {"skipped": True, "healthy": cam.healthy}
            else:
                due.append(cam)
        reads: dict[int, bool] = {}
        # drop finished leftovers; a camera whose PREVIOUS probe still hasn't
        # returned is counted failed without spawning another read on the
        # same (non-thread-safe) handle
        self._inflight = {c: t for c, t in self._inflight.items() if t.is_alive()}
        fresh = []
        for cam in due:
            if cam.id in self._inflight:
                reads[cam.id] = False
            else:
                fresh.append(cam)
        # probe in daemon-thread chunks of `concurrency`: every spawned
        # probe gets the FULL request_timeout from its own start (a queued
        # camera waits for the next chunk rather than falsely timing out
        # behind a slow neighbor), and a wedged read is abandoned (daemon:
        # never blocks interpreter exit)
        for start in range(0, len(fresh), self.concurrency):
            chunk = fresh[start : start + self.concurrency]
            probes = []
            for cam in chunk:
                holder: dict = {}

                def run(cam=cam, holder=holder):
                    try:
                        holder["ok"] = bool(cam.read()[0])
                    except Exception:
                        holder["ok"] = False

                t = threading.Thread(target=run, daemon=True,
                                     name=f"health-probe-{cam.id}")
                t.start()
                probes.append((cam, t, holder, time.monotonic()))
            for cam, t, holder, t0 in probes:
                t.join(timeout=max(
                    0.0, self.request_timeout - (time.monotonic() - t0)))
                if t.is_alive():  # wedged past its timeout: fail + remember
                    self._inflight[cam.id] = t
                    reads[cam.id] = False
                else:
                    reads[cam.id] = holder.get("ok", False)
        for cam in due:
            ok = reads.get(cam.id, False)
            self.probes += 1
            if ok:
                self._next_probe[cam.id] = now + self.interval
            else:
                # exponential backoff on consecutive failures; the exponent
                # must be clamped — consecutive_failures grows unbounded
                # (one per scan tick on a dead camera), and 2**1024
                # overflows the float multiply, killing the whole probe loop
                delay = min(
                    self.backoff_cap,
                    self.backoff_base * (2 ** min(cam.consecutive_failures, 16)),
                )
                self._next_probe[cam.id] = now + delay
            results[cam.id] = {
                "healthy": cam.healthy,
                "consecutive_failures": cam.consecutive_failures,
                "last_seen": cam.last_seen,
            }
            if self._coll is not None:
                try:
                    self._coll.update_one(
                        {"camera_id": cam.id},
                        {
                            "$set": {
                                "camera_id": cam.id,
                                "name": cam.name,
                                "healthy": cam.healthy,
                                "last_seen": cam.last_seen,
                                "consecutive_failures": cam.consecutive_failures,
                            }
                        },
                        upsert=True,
                    )
                except Exception:
                    logger.exception("camera health persistence failed (non-fatal)")
        return results
