"""Tiered snapshot cache — in-proc LRU (TTL) + disk with quota eviction.

Reference: ``backend/app/utils/thumbnail_cache.py`` — Redis (optional) ->
in-proc LRU(512, TTL 30 s) -> disk with sha1-hashed filenames, atomic write +
fsync, 200 MB quota with LRU-by-mtime eviction. Same tiers here; Redis is
gated on ``REDIS_URL`` + an importable client, the embedded tiers carry the
load otherwise. Synchronous with fine-grained locks (operations are
sub-millisecond; the asyncio edge calls via ``asyncio.to_thread`` when it
matters).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict


class ThumbnailCache:
    def __init__(
        self,
        disk_dir: str = "data/snapshots_cache",
        mem_entries: int = 512,
        ttl: float = 30.0,
        disk_quota_mb: int = 200,
        redis_url: str = "",
        redis_ttl: float | None = None,
        disk_quota_bytes: int = 0,
        cleanup_batch: int = 0,
    ):
        # redis_ttl: THUMB_CACHE_REDIS_TTL (defaults to the mem TTL);
        # disk_quota_bytes: THUMB_MAX_DISK_BYTES (wins over the MB knob);
        # cleanup_batch: THUMB_DISK_CLEANUP_BATCH — evict at least this many
        # files once over quota (reference thumbnail_cache.py:198-237
        # amortizes directory scans by deleting in batches)
        self._dir = disk_dir
        self._ttl = ttl
        self._redis_ttl = ttl if redis_ttl is None else redis_ttl
        self._mem_entries = mem_entries
        self._quota = disk_quota_bytes or disk_quota_mb * 1024 * 1024
        self._cleanup_batch = cleanup_batch
        self._mem: OrderedDict[str, tuple[float, bytes]] = OrderedDict()
        self._lock = threading.Lock()
        self._redis = None
        if redis_url:
            try:
                import redis

                self._redis = redis.Redis.from_url(redis_url, socket_timeout=1)
                self._redis.ping()
            except Exception:
                self._redis = None
        os.makedirs(disk_dir, exist_ok=True)
        # purge tmp files orphaned by interrupted set() writes: eviction and
        # quota accounting only see '.bin', so leaked tmp bytes were
        # invisible and accumulated forever
        try:
            for name in os.listdir(disk_dir):
                if ".tmp" in name:
                    try:
                        os.remove(os.path.join(disk_dir, name))
                    except OSError:
                        pass
        except OSError:
            pass

    def _path(self, key: str) -> str:
        return os.path.join(self._dir, hashlib.sha1(key.encode()).hexdigest() + ".bin")

    # -- get/set --------------------------------------------------------------
    def get(self, key: str) -> bytes | None:
        now = time.time()
        with self._lock:
            hit = self._mem.get(key)
            if hit is not None:
                ts, data = hit
                if now - ts <= self._ttl:
                    self._mem.move_to_end(key)
                    return data
                del self._mem[key]
        if self._redis is not None:
            try:
                data = self._redis.get("thumb:" + key)
                if data:
                    self._mem_put(key, data)
                    return data
            except Exception:
                pass
        path = self._path(key)
        try:
            # the disk tier honors the TTL too: a TTL-free disk read (which
            # even refreshed mtime) made the first-ever captured frame
            # permanent — snapshot routes would serve it forever, across
            # restarts, while claiming Cache-Control: max-age=5
            if time.time() - os.path.getmtime(path) > self._ttl:
                return None
            with open(path, "rb") as f:
                data = f.read()
            self._mem_put(key, data)
            return data
        except OSError:
            return None

    def _mem_put(self, key: str, data: bytes):
        with self._lock:
            self._mem[key] = (time.time(), data)
            self._mem.move_to_end(key)
            while len(self._mem) > self._mem_entries:
                self._mem.popitem(last=False)

    def set(self, key: str, data: bytes):
        self._mem_put(key, data)
        if self._redis is not None:
            try:
                self._redis.setex("thumb:" + key, int(self._redis_ttl), data)
            except Exception:
                pass
        path = self._path(key)
        tmp = path + f".{os.getpid()}.tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            return
        self._evict_disk()

    def delete(self, key: str):
        with self._lock:
            self._mem.pop(key, None)
        if self._redis is not None:
            try:
                self._redis.delete("thumb:" + key)
            except Exception:
                pass
        try:
            os.remove(self._path(key))
        except OSError:
            pass

    def _evict_disk(self):
        try:
            entries = [
                (os.path.getmtime(p), os.path.getsize(p), p)
                for p in (
                    os.path.join(self._dir, f) for f in os.listdir(self._dir)
                )
                if p.endswith(".bin")
            ]
        except OSError:
            return
        total = sum(s for _, s, _ in entries)
        if total <= self._quota:
            return
        entries.sort()  # oldest mtime first
        removed = 0
        for _, size, path in entries:
            try:
                os.remove(path)
                total -= size
                removed += 1
            except OSError:
                pass
            if total <= self._quota and removed >= self._cleanup_batch:
                break

    def stats(self) -> dict:
        with self._lock:
            mem = len(self._mem)
        try:
            files = [
                os.path.join(self._dir, f)
                for f in os.listdir(self._dir)
                if f.endswith(".bin")
            ]
            disk_bytes = sum(os.path.getsize(p) for p in files)
            disk = len(files)
        except OSError:
            disk, disk_bytes = 0, 0
        return {
            "memory_entries": mem,
            "disk_entries": disk,
            "disk_bytes": disk_bytes,
            "quota_bytes": self._quota,
            "ttl_seconds": self._ttl,
            "redis": self._redis is not None,
        }
