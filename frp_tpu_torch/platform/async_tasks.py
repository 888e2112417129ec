"""Async job manager (port of ``frp_tpu/platform/async_tasks.py``) — enqueue
face searches, run them against the device pipeline, emit
job_started/job_finished/job_failed events.

Reference: ``backend/app/services/async_task_manager.py`` — in-memory registry
+ ThreadPoolExecutor(1) + Socket.IO events. Its dispatch is broken by design
(duck-types search_face/find_matches/... none of which exist on FaceService,
:116-147, so every job fails). Here the job runner calls the real
``face_service.compare_image`` path, so the frontend's async search panel
(FaceUpload.jsx:157-232) works end to end (SURVEY.md section 3.6 rebuild
requirement).
"""

from __future__ import annotations

import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from frp_tpu_torch.utils.logger import get_logger

logger = get_logger("frp.platform.async_tasks")


class AsyncTaskManager:
    def __init__(
        self,
        face_service=None,
        event_hub=None,
        jobs_collection=None,
        max_workers: int = 1,
        retention_seconds: float = 3600.0,
    ):
        self.face_service = face_service
        self._event_hub = event_hub
        self._jobs_coll = jobs_collection
        self._executor = ThreadPoolExecutor(max_workers=max(1, max_workers))
        self._jobs: dict[str, dict] = {}
        self._lock = threading.RLock()
        self.retention_seconds = retention_seconds

    # ------------------------------------------------------------------
    def enqueue_face_search(
        self, image: np.ndarray, tolerance: float | None = None, meta: dict | None = None
    ) -> dict:
        job_id = uuid.uuid4().hex
        job = {
            "job_id": job_id,
            "type": "face_search",
            "status": "queued",
            "created_at": time.time(),
            "meta": meta or {},
            "result": None,
            "error": None,
        }
        with self._lock:
            self._cleanup_locked()
            self._jobs[job_id] = job
        self._executor.submit(self._run_job, job_id, image, tolerance)
        return {"job_id": job_id, "status": "queued"}

    def _run_job(self, job_id: str, image, tolerance):
        self._set(job_id, status="running", started_at=time.time())
        self._emit("job_started", {"job_id": job_id})
        try:
            if self.face_service is None:
                raise RuntimeError("face service unavailable")
            result = self.face_service.compare_image(image, tolerance)
            self._set(
                job_id,
                status="finished",
                finished_at=time.time(),
                result=self._strip(result),
            )
            self._emit("job_finished", {"job_id": job_id, "result": self._strip(result)})
            self._persist(job_id)
        except Exception as e:
            logger.exception("job %s failed", job_id)
            self._set(job_id, status="failed", finished_at=time.time(), error=str(e))
            self._emit("job_failed", {"job_id": job_id, "error": str(e)})
            self._persist(job_id)

    @staticmethod
    def _strip(result: dict) -> dict:
        """Drop embeddings from results shipped over the wire."""
        out = dict(result)
        out.pop("faces", None)
        return out

    def _set(self, job_id: str, **fields):
        with self._lock:
            job = self._jobs.get(job_id)
            if job is not None:
                job.update(fields)

    def _emit(self, event: str, data: dict):
        if self._event_hub is not None:
            self._event_hub.emit(event, data)

    def _persist(self, job_id: str):
        if self._jobs_coll is None:
            return
        with self._lock:
            job = dict(self._jobs.get(job_id) or {})
        if job:
            try:
                self._jobs_coll.update_one(
                    {"job_id": job_id}, {"$set": job}, upsert=True
                )
            except Exception:
                logger.exception("job persistence failed (non-fatal)")

    # ------------------------------------------------------------------
    def get_job(self, job_id: str) -> dict | None:
        with self._lock:
            job = self._jobs.get(job_id)
            return dict(job) if job else None

    def list_jobs(self, status: str | None = None) -> list:
        with self._lock:
            jobs = [dict(j) for j in self._jobs.values()]
        if status:
            jobs = [j for j in jobs if j["status"] == status]
        return sorted(jobs, key=lambda j: j["created_at"], reverse=True)

    def _cleanup_locked(self):
        cutoff = time.time() - self.retention_seconds
        stale = [
            jid
            for jid, j in self._jobs.items()
            if j["status"] in ("finished", "failed") and j["created_at"] < cutoff
        ]
        for jid in stale:
            del self._jobs[jid]

    def stats(self) -> dict:
        with self._lock:
            by_status: dict[str, int] = {}
            for j in self._jobs.values():
                by_status[j["status"]] = by_status.get(j["status"], 0) + 1
            return {"jobs": len(self._jobs), "by_status": by_status}

    def shutdown(self):
        self._executor.shutdown(wait=False)
