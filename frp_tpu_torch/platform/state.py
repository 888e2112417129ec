"""Shared runtime state of the port's platform (a copy of
``frp_tpu/platform/state.py``): camera registry and frame sources, model
manager, event hub.

Frame acquisition is an abstraction (device/RTSP/file via cv2, pushed frames,
and a synthetic source for tests and benches); the cameras live in a locked
registry; embeddings live in the engine's ``DeviceGallery``. The synthetic
source renders with the port's ``testing/synthetic.py``, the same numpy
renderer as the JAX package's, so both packages see the same frames.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from frp_tpu_torch.testing.synthetic import make_identity, render_face
from frp_tpu_torch.utils.logger import get_logger

logger = get_logger("frp.platform.state")

DEFAULT_CAMERA_CONFIGS = [
    # The reference ships a 5-camera Pune example config (main.py:75-81);
    # sources default to synthetic so the platform runs anywhere.
    {"id": 0, "name": "Shivaji Nagar Chauk 1", "geo": (18.555, 73.808)},
    {"id": 1, "name": "Pune Station", "geo": (18.528, 73.847)},
    {"id": 2, "name": "FC Road Signal", "geo": (18.516, 73.841)},
    {"id": 3, "name": "Kothrud Square", "geo": (18.504, 73.823)},
    {"id": 4, "name": "Swargate Bus Stop", "geo": (18.501, 73.862)},
]


class FrameSource:
    """Abstract frame provider. read() -> (ok, frame BGR uint8 | None)."""

    def read(self):
        raise NotImplementedError

    def read_hints(self):
        """Change hints for the LAST read() frame: a list of (y0, y1) source
        row bands covering every pixel that changed since the PREVIOUS
        read, or None when unknown (callers then do a full re-letterbox —
        engine/batching.LetterboxCache). Real decoders know this from the
        bitstream (H.264/HEVC macroblock rows); synthetic sources know
        their own motion. MUST over-report rather than under-report: missed
        changes persist as stale pixels in the letterbox cache."""
        return None

    def release(self):
        pass

    @property
    def opened(self) -> bool:
        return True

    def restart(self) -> bool:
        return True


class SyntheticSource(FrameSource):
    """Deterministic frames with a moving synthetic face — drives tests,
    benches, and demo deployments with no hardware (subsumes
    tools/mock_camera_worker.py). The rendered face matches the distribution
    the bootstrap detector weights are trained on
    (frp_tpu/train/synthetic.py), so the full scan -> track -> alert loop
    produces real positives out of the box."""

    def __init__(self, width: int = 1280, height: int = 720, seed: int = 0):
        self.w, self.h = width, height
        self._tick = 0
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        # the background in BGR, the order read() delivers: a read copies it
        # and flips only the face's window, not the whole frame
        self._base = np.ascontiguousarray(
            self._rng.integers(0, 110, size=(height, width, 3), dtype=np.uint8)[..., ::-1])
        self._prev_band: tuple | None = None
        self._hints: list | None = None

    def read(self):
        self._tick += 1
        # render in RGB (train.synthetic's convention), deliver BGR like a
        # real cv2 camera — downstream batching flips it back
        frame = self._base.copy()
        size = self.h / 4.0
        margin = size
        cx = margin + (self._tick * 17 + self._seed * 53) % max(1, int(self.w - 2 * margin))
        cy = margin + (self._tick * 11 + self._seed * 31) % max(1, int(self.h - 2 * margin))
        # the face fits in cx, cy +- size; rendering that window alone gives
        # the bytes of a whole-frame render (render_face's origin)
        x0, y0 = max(0, int(cx - size)), max(0, int(cy - size))
        x1, y1 = min(self.w, int(cx + size) + 1), min(self.h, int(cy + size) + 1)
        window = frame[y0:y1, x0:x1, ::-1].copy()
        render_face(window, float(cx), float(cy), size,
                    np.random.default_rng(self._seed),
                    identity=make_identity(self._seed), origin=(x0, y0))
        frame[y0:y1, x0:x1] = window[..., ::-1]
        # change hints: the face moved — only its previous and current row
        # bands differ between consecutive reads (over-reported by a full
        # face-size margin; render extent is <= 0.55*size vertically)
        band = (max(0, int(cy - size)), min(self.h, int(cy + size) + 1))
        self._hints = [b for b in (self._prev_band, band) if b is not None]
        self._prev_band = band
        return True, frame

    def read_hints(self):
        return self._hints


class PushSource(FrameSource):
    """Frames pushed over HTTP (the ingest endpoint) — realizes the
    reference's mock-camera-worker flow whose target endpoint never existed
    (tools/mock_camera_worker.py -> /api/camera/ingest; SURVEY.md defect)."""

    def __init__(self):
        self._frame = None
        self._lock = threading.Lock()
        self.pushed = 0

    def push(self, frame) -> None:
        with self._lock:
            self._frame = frame
            self.pushed += 1

    def read(self):
        with self._lock:
            if self._frame is None:
                return False, None
            return True, self._frame.copy()

    @property
    def opened(self) -> bool:
        return True


class VideoFileSource(FrameSource):
    """Loops a video file (cv2)."""

    def __init__(self, path: str):
        self.path = path
        self._cap = cv2.VideoCapture(path) if cv2 is not None else None

    @property
    def opened(self) -> bool:
        return bool(self._cap is not None and self._cap.isOpened())

    def read(self):
        if not self.opened:
            return False, None
        ok, frame = self._cap.read()
        if not ok:  # loop
            self._cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
            ok, frame = self._cap.read()
        return ok, frame

    def restart(self) -> bool:
        self.release()
        self._cap = cv2.VideoCapture(self.path) if cv2 is not None else None
        return self.opened

    def release(self):
        if self._cap is not None:
            self._cap.release()
            self._cap = None


class DeviceSource(FrameSource):
    """A live device index or RTSP/HTTP URL via cv2.VideoCapture."""

    def __init__(self, target):
        self.target = target
        self._cap = cv2.VideoCapture(target) if cv2 is not None else None

    @property
    def opened(self) -> bool:
        return bool(self._cap is not None and self._cap.isOpened())

    def read(self):
        if not self.opened:
            return False, None
        return self._cap.read()

    def restart(self) -> bool:
        self.release()
        self._cap = cv2.VideoCapture(self.target) if cv2 is not None else None
        return self.opened

    def release(self):
        if self._cap is not None:
            self._cap.release()
            self._cap = None


def make_source(spec) -> FrameSource:
    """Build a source from a config spec: int / "rtsp://..." / "file:x.mp4" /
    "synthetic" / "synthetic:WxH"."""
    if isinstance(spec, int):
        return DeviceSource(spec)
    if isinstance(spec, str):
        if spec == "push":
            return PushSource()
        if spec.startswith("synthetic"):
            if ":" in spec:
                dims = spec.split(":", 1)[1]
                w, h = (int(v) for v in dims.split("x"))
                return SyntheticSource(w, h)
            return SyntheticSource()
        if spec.startswith("file:"):
            return VideoFileSource(spec[5:])
        return DeviceSource(spec)
    return SyntheticSource()


class Camera:
    def __init__(self, cam_id: int, name: str, geo=(0.0, 0.0), source="synthetic"):
        self.id = int(cam_id)
        self.name = name
        self.geo = tuple(geo)
        self.source_spec = source
        self.source = make_source(source)
        self.lock = threading.Lock()
        self.healthy = self.source.opened
        self.consecutive_failures = 0
        self.last_seen: float | None = time.time() if self.healthy else None
        self.fps_window: list[float] = []
        self.frames_read = 0
        # every read of the source, whoever made it, and the count right
        # after the scan's last read (read_with_hints)
        self.reads = 0
        self._scan_read: int | None = None

    def read(self):
        with self.lock:
            return self._read_locked()

    def _read_locked(self):
        t0 = time.perf_counter()
        ok, frame = self.source.read()
        self.reads += 1
        if ok and frame is not None:
            self.frames_read += 1
            self.last_seen = time.time()
            self.consecutive_failures = 0
            self.healthy = True
            dt = time.perf_counter() - t0
            self.fps_window.append(dt)
            if len(self.fps_window) > 100:
                self.fps_window.pop(0)
        else:
            self.consecutive_failures += 1
            if self.consecutive_failures >= 3:
                self.healthy = False
        return ok, frame

    def read_hints(self):
        """Delegate change hints to the underlying source: the bands of the
        source's LAST read, whoever made it."""
        src_hints = getattr(self.source, "read_hints", None)
        return src_hints() if src_hints is not None else None

    def read_with_hints(self):
        """(ok, frame, bands) under the camera's lock: a read, and the
        source's change hints when they cover every pixel that changed since
        the previous read_with_hints (the scan's previous frame), that is
        when nobody else read the camera in between; else None (a full
        letterbox). The JAX package's scan pairs read() with read_hints(),
        which covers only the change from the LAST read: a health probe or a
        snapshot between two scans then leaves stale pixels in the scan's
        letterbox cache."""
        with self.lock:
            fresh = self._scan_read == self.reads
            ok, frame = self._read_locked()
            self._scan_read = self.reads
            return ok, frame, (self.read_hints() if ok and fresh else None)

    def restart(self) -> bool:
        with self.lock:
            ok = self.source.restart()
            self.healthy = ok
            self.consecutive_failures = 0 if ok else self.consecutive_failures
            self._scan_read = None
            return ok

    def release(self):
        with self.lock:
            self.source.release()

    def info(self) -> dict:
        avg = sum(self.fps_window) / len(self.fps_window) if self.fps_window else 0.0
        return {
            "id": self.id,
            "name": self.name,
            "geo": list(self.geo),
            "source": str(self.source_spec),
            "healthy": self.healthy,
            "last_seen": self.last_seen,
            "consecutive_failures": self.consecutive_failures,
            "frames_read": self.frames_read,
            "avg_read_time": round(avg, 5),
        }


class CameraRegistry:
    """Thread-safe camera collection (fixes the reference's unlocked CAMERAS
    mutations, SURVEY.md section 5 race note)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._cams: dict[int, Camera] = {}

    def init_cameras(self, configs: list[dict]):
        for cfg in configs:
            self.add(
                cfg["id"],
                cfg.get("name", f"Camera {cfg['id']}"),
                cfg.get("geo", (0.0, 0.0)),
                cfg.get("source", "synthetic"),
            )

    def add(self, cam_id: int, name: str, geo=(0.0, 0.0), source="synthetic"):
        with self._lock:
            if cam_id in self._cams:
                raise ValueError(f"camera {cam_id} already exists")
            self._cams[int(cam_id)] = Camera(cam_id, name, geo, source)
            return self._cams[int(cam_id)]

    def update(self, cam_id: int, **fields):
        with self._lock:
            cam = self._cams.get(int(cam_id))
            if cam is None:
                return None
            if "name" in fields and fields["name"] is not None:
                cam.name = fields["name"]
            if "geo" in fields and fields["geo"] is not None:
                cam.geo = tuple(fields["geo"])
            if "source" in fields and fields["source"] is not None:
                # build the NEW source before releasing the old one: an
                # invalid spec raises out of make_source, and releasing
                # first would leave the camera permanently dead even though
                # the update "failed" (route returns the error either way)
                new_source = make_source(fields["source"])
                cam.release()
                cam.source_spec = fields["source"]
                cam.source = new_source
                cam.healthy = cam.source.opened
                cam._scan_read = None
            return cam

    def remove(self, cam_id: int) -> bool:
        with self._lock:
            cam = self._cams.pop(int(cam_id), None)
        if cam is not None:
            cam.release()
            return True
        return False

    def get(self, cam_id: int) -> Camera | None:
        with self._lock:
            return self._cams.get(int(cam_id))

    def all(self) -> list[Camera]:
        with self._lock:
            return list(self._cams.values())

    def ids(self) -> list[int]:
        with self._lock:
            return sorted(self._cams.keys())

    def metadata(self) -> dict[int, dict]:
        with self._lock:
            return {c.id: {"name": c.name, "geo": c.geo} for c in self._cams.values()}

    def close_all(self):
        for cam in self.all():
            cam.release()

    def read_all(self) -> dict[int, np.ndarray | None]:
        """Grab one frame per camera (the batcher's input)."""
        frames = {}
        for cam in self.all():
            ok, frame = cam.read()
            frames[cam.id] = frame if ok else None
        return frames


class ModelManager:
    """Lazy model loading with idle unload — reference ``state.py:135-262``."""

    def __init__(self, idle_unload_seconds: float = 600.0,
                 max_memory_mb: float = 0.0):
        self._loaders: dict[str, Callable[[], Any]] = {}
        self._models: dict[str, Any] = {}
        self._last_used: dict[str, float] = {}
        self._lock = threading.RLock()
        self.idle_unload_seconds = idle_unload_seconds
        # MODEL_MAX_MEMORY_MB (reference state.py:117-125, enforced at
        # load): when process RSS exceeds the cap after a load, evict
        # least-recently-used OTHER models. <=0 disables.
        self.max_memory_mb = max_memory_mb

    def register_loader(self, name: str, loader: Callable[[], Any]):
        with self._lock:
            self._loaders[name] = loader

    def get_model(self, name: str):
        with self._lock:
            if name in self._models:
                self._last_used[name] = time.time()
                return self._models[name]
            loader = self._loaders.get(name)
            if loader is None:
                raise KeyError(f"no loader registered for model '{name}'")
        model = loader()  # outside lock: loads can be slow
        with self._lock:
            self._models[name] = model
            self._last_used[name] = time.time()
            self._enforce_memory_cap(keep=name)
            return model

    def _enforce_memory_cap(self, keep: str) -> list[str]:
        """Best-effort: when process RSS exceeds max_memory_mb after a
        load, evict the LRU other model (at most one per load, + gc).
        Called under the lock.

        Deliberately NOT a loop-to-target: a serving process's RSS
        baseline (allocator arenas, loaded kernels) can sit above the
        cap for reasons unrelated to this manager, and dict eviction
        cannot reliably lower RSS — looping would evict everything and
        thrash reloads forever while recovering nothing."""
        if self.max_memory_mb <= 0 or self._rss_mb() <= self.max_memory_mb:
            return []
        lru = min((n for n in self._models if n != keep),
                  key=lambda n: self._last_used.get(n, 0), default=None)
        if lru is None:
            return []
        del self._models[lru]
        self._last_used.pop(lru, None)
        import gc

        gc.collect()
        return [lru]

    @staticmethod
    def _rss_mb() -> float:
        # current (not peak) RSS — eviction must be able to lower it
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        return float(line.split()[1]) / 1024.0
        except OSError:  # pragma: no cover - non-linux
            pass
        try:  # pragma: no cover - fallback
            import psutil

            return psutil.Process().memory_info().rss / (1024.0 * 1024.0)
        except Exception:
            return 0.0

    def unload_model(self, name: str) -> bool:
        with self._lock:
            self._last_used.pop(name, None)
            return self._models.pop(name, None) is not None

    def cleanup_idle_models(self) -> list[str]:
        now = time.time()
        unloaded = []
        with self._lock:
            for name in list(self._models.keys()):
                if now - self._last_used.get(name, 0) > self.idle_unload_seconds:
                    del self._models[name]
                    self._last_used.pop(name, None)
                    unloaded.append(name)
        return unloaded

    def loaded(self) -> list[str]:
        with self._lock:
            return list(self._models.keys())


class EventHub:
    """In-process pub/sub the Socket.IO edge subscribes to — the
    replacement for the reference's SIO_MANAGER/emit_event (state.py:47-67).
    Also the fix for SURVEY.md's observability note: the alert/tracking path
    emits new_alert / update_movement_log / update_tracking_feed here so the
    dashboard actually goes live."""

    def __init__(self):
        self._subs: list[Callable[[str, Any], None]] = []
        self._lock = threading.Lock()
        self.emitted = 0

    def subscribe(self, fn: Callable[[str, Any], None]):
        with self._lock:
            self._subs.append(fn)

    def emit(self, event: str, data: Any):
        with self._lock:
            subs = list(self._subs)
            self.emitted += 1
        for fn in subs:
            try:
                fn(event, data)
            except Exception:
                logger.exception("event subscriber failed for %s", event)


def memory_info() -> dict:
    """Process memory info — psutil if available, /proc fallback
    (reference state.py:317-343)."""
    try:
        import psutil

        p = psutil.Process()
        mi = p.memory_info()
        return {"rss_mb": mi.rss / 1e6, "vms_mb": mi.vms / 1e6, "source": "psutil"}
    except ImportError:
        pass
    try:
        with open("/proc/self/status") as f:
            fields = dict(
                line.split(":", 1) for line in f if ":" in line
            )
        rss = float(fields.get("VmRSS", "0 kB").strip().split()[0]) / 1e3
        return {"rss_mb": rss, "vms_mb": None, "source": "procfs"}
    except (OSError, ValueError, IndexError):
        return {"rss_mb": None, "vms_mb": None, "source": "unavailable"}
