"""Face service: enrollment, comparison, clustering, quality, metrics.

The behavior contract is ``backend/app/services/face_service.py`` (encode with
TTL cache + retry, store with duplicate warning + encrypted persistence +
atomic JSON backup, vectorized compare with tolerance semantics, confidence
bands + sigmoid calibration, greedy clustering, k-NN, quality/perf metrics,
storage sync, health check) — but the compute core is the device-resident
engine: one fused detect->align->embed graph instead of dlib calls, and the
gallery is a device matrix matched with one matmul instead of a re-built
numpy array per compare (face_service.py:409-411).

Startup hydration: unlike the reference (ENCODINGS starts empty and is never
reloaded, SURVEY.md section 5 checkpoint note), ``hydrate()`` decrypts every
stored embedding into the device gallery at boot.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque
from datetime import datetime

import numpy as np

from frp_tpu_torch.engine.gallery import DeviceGallery
from frp_tpu_torch.ops.matching import calibrate_confidence, confidence_level, find_k_nearest
from frp_tpu_torch.ops.quality import assess_quality_host
from frp_tpu_torch.utils.crypto import EmbeddingCipher
from frp_tpu_torch.utils.logger import audit_event, get_logger

logger = get_logger("frp.platform.face_service")


class FaceService:
    def __init__(
        self,
        engine,
        faces_collection=None,
        cipher: EmbeddingCipher | None = None,
        tolerance: float = 0.6,
        cache_ttl: float = 300.0,
        cache_size: int = 256,
        backup_dir: str = "data/backups",
    ):
        self.engine = engine
        self.gallery: DeviceGallery = engine.gallery
        self._faces_coll = faces_collection
        self._cipher = cipher
        self.tolerance = tolerance
        self._backup_dir = backup_dir
        self._lock = threading.RLock()

        # encode TTL cache keyed by content hash (face_service.py:116-134)
        self._cache: OrderedDict[str, tuple[float, list]] = OrderedDict()
        self._cache_ttl = cache_ttl
        self._cache_size = cache_size

        self._quality_history: deque = deque(maxlen=500)
        self.metrics = {
            "encode_calls": 0,
            "encode_cache_hits": 0,
            "encode_time_total": 0.0,
            "compare_calls": 0,
            "compare_time_total": 0.0,
            "encode_failures": 0,
        }

    # ------------------------------------------------------------------
    # encoding
    # ------------------------------------------------------------------
    def _cache_key(self, image: np.ndarray) -> str:
        import hashlib

        h = hashlib.sha1()
        h.update(np.ascontiguousarray(image[:: max(1, image.shape[0] // 64)]).tobytes())
        h.update(str(image.shape).encode())
        return h.hexdigest()

    def encode_image(
        self, image: np.ndarray, use_cache: bool = True, retries: int = 1
    ) -> dict:
        """Detect + embed all faces in an RGB uint8 image.

        Returns {"success", "face_count", "faces": [{embedding, box,
        landmarks, score, quality...}], "processing_time"} — the engine-backed
        equivalent of encode_face (face_service.py:87-219), including TTL
        cache and retry semantics.
        """
        t0 = time.perf_counter()
        key = self._cache_key(image) if use_cache else None
        if key is not None:
            with self._lock:
                hit = self._cache.get(key)
                if hit is not None and time.perf_counter() - hit[0] <= self._cache_ttl:
                    self._cache.move_to_end(key)
                    self.metrics["encode_cache_hits"] += 1
                    self.metrics["encode_calls"] += 1
                    return {
                        "success": True,
                        "face_count": len(hit[1]),
                        "faces": hit[1],
                        "cached": True,
                        "processing_time": time.perf_counter() - t0,
                    }

        faces = []
        last_err = None
        for attempt in range(retries + 1):
            try:
                # engine letterboxes to its one canonical geometry and
                # returns original-image coordinates (pipeline.encode_image)
                faces = self.engine.encode_image(image)
                break
            except Exception as e:  # engine-level failure: retry once
                last_err = e
                logger.warning("encode attempt %d failed: %s", attempt + 1, e)
        else:
            with self._lock:
                self.metrics["encode_failures"] += 1
            return {
                "success": False,
                "face_count": 0,
                "faces": [],
                "message": str(last_err),
                "processing_time": time.perf_counter() - t0,
            }

        dt = time.perf_counter() - t0
        with self._lock:
            self.metrics["encode_calls"] += 1
            self.metrics["encode_time_total"] += dt
            if key is not None:
                self._cache[key] = (time.perf_counter(), faces)
                self._cache.move_to_end(key)
                while len(self._cache) > self._cache_size:
                    self._cache.popitem(last=False)
        return {
            "success": True,
            "face_count": len(faces),
            "faces": faces,
            "cached": False,
            "processing_time": dt,
        }

    def batch_encode(self, images: list) -> list:
        """Batch enrollment (face_service.py:224-246) — device-batched rather
        than thread-pooled: all images go through the engine back-to-back."""
        results = []
        for img in images:
            try:
                results.append(self.encode_image(img))
            except Exception as e:
                results.append(
                    {"success": False, "message": str(e), "face_count": 0, "faces": []}
                )
        return results

    # ------------------------------------------------------------------
    # quality (exact host replica for the enrollment gate)
    # ------------------------------------------------------------------
    def assess_face_quality(self, image: np.ndarray, face_location) -> dict:
        q = assess_quality_host(image, face_location)
        self._quality_history.append(
            {
                "timestamp": datetime.now().isoformat(),
                "score": q["score"],
                "blur_score": q["blur_score"],
                "lighting_score": q["lighting_score"],
            }
        )
        return q

    # ------------------------------------------------------------------
    # storage
    # ------------------------------------------------------------------
    def store_face(self, target_name: str, embedding: np.ndarray) -> dict:
        """face_service.py:344-390: duplicate warning at distance < 0.3,
        encrypted persistence, gallery insert, atomic JSON backup."""
        emb = np.asarray(embedding, np.float32).reshape(-1)
        warning = None
        mat, names = self.gallery.host_arrays()
        if len(names):
            dists = np.linalg.norm(mat - emb[None, :], axis=1)
            i = int(np.argmin(dists))
            if dists[i] < 0.3 and names[i] != target_name:
                warning = (
                    f"Very similar to existing face '{names[i]}' "
                    f"(distance {dists[i]:.3f})"
                )

        if self._faces_coll is not None:
            token = (
                self._cipher.encrypt_embedding(emb)
                if self._cipher is not None
                else json.dumps(emb.tolist())
            )
            # schema gate at the store boundary (reference person.py:34-68
            # FaceModel: embedding persisted only as the encrypted token);
            # a ValidationError propagates to the route as a 422
            from frp_tpu_torch.platform.schemas import FaceModel

            doc = FaceModel(
                target=target_name,
                embedding=token,
                updated_at=datetime.now().isoformat(),
            ).model_dump(exclude_none=True)
            self._faces_coll.update_one(
                {"target": doc["target"]},
                {"$set": {k: v for k, v in doc.items() if k != "target"}},
                upsert=True,
            )
        self.gallery.add(target_name, emb)
        self._write_backup(target_name, emb)
        audit_event("face_stored", {"target": target_name})
        return {"success": True, "target": target_name, "warning": warning}

    @staticmethod
    def _safe_file_stem(target: str) -> str:
        """Filesystem-safe stem for backup files. Route path params are
        percent-DECODED after matching (api/http.py), so '..%2F..' arrives
        as a literal '../..' — without this, delete_face could remove any
        '*_backup.json' outside the backup dir (same sanitization as
        FederatedService._path)."""
        import re

        return re.sub(r"[^A-Za-z0-9._-]", "_", target)[:128] or "_"

    def _write_backup(self, target: str, emb: np.ndarray):
        try:
            os.makedirs(self._backup_dir, exist_ok=True)
            path = os.path.join(
                self._backup_dir, f"{self._safe_file_stem(target)}_backup.json"
            )
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(
                    {"target": target, "encoding": emb.tolist(),
                     "saved_at": datetime.now().isoformat()},
                    f,
                )
            os.replace(tmp, path)
        except OSError:
            logger.warning("backup write failed for %s (non-fatal)", target)

    def delete_face(self, target_name: str) -> dict:
        removed_mem = self.gallery.remove(target_name)
        removed_db = False
        if self._faces_coll is not None:
            res = self._faces_coll.delete_one({"target": target_name})
            removed_db = getattr(res, "deleted_count", 0) > 0
        try:
            path = os.path.join(
                self._backup_dir, f"{self._safe_file_stem(target_name)}_backup.json"
            )
            if os.path.exists(path):
                os.remove(path)
        except OSError:
            pass
        ok = removed_mem or removed_db
        if ok:
            audit_event("face_deleted", {"target": target_name})
        return {
            "success": ok,
            "message": f"Face '{target_name}' deleted successfully"
            if ok
            else f"Face '{target_name}' not found in database or memory",
            "removed_from_memory": removed_mem,
            "removed_from_db": removed_db,
        }

    def get_all_targets(self) -> list:
        return self.gallery.names

    def hydrate(self) -> int:
        """Decrypt every stored embedding into the device gallery (startup).
        The reference never does this (db.py:484-490 helper exists unused)."""
        if self._faces_coll is None:
            return 0
        count = 0
        for doc in self._faces_coll.find({}):
            target = doc.get("target")
            token = doc.get("embedding")
            if not target or not isinstance(token, str):
                continue
            emb = (
                self._cipher.decrypt_embedding(token)
                if self._cipher is not None
                else None
            )
            if emb is None:
                try:
                    emb = np.asarray(json.loads(token), np.float64)
                except (ValueError, json.JSONDecodeError):
                    continue
            try:
                self.gallery.add(target, emb)
                count += 1
            except ValueError:
                continue
        logger.info("hydrated %d gallery entries from store", count)
        return count

    def sync_storage(self) -> dict:
        """Reconcile store <-> gallery (face_service.py storage-sync path)."""
        before = len(self.gallery)
        loaded = self.hydrate()
        return {"gallery_before": before, "loaded": loaded, "gallery_after": len(self.gallery)}

    # ------------------------------------------------------------------
    # comparison
    # ------------------------------------------------------------------
    def compare_embedding(
        self, embedding: np.ndarray, tolerance: float | None = None, top_k: int = 5
    ) -> dict:
        """Vectorized gallery compare with reference result semantics
        (face_service.py:395-443): matches below tolerance, best match,
        confidence band + calibrated score per result."""
        t0 = time.perf_counter()
        tol = self.tolerance if tolerance is None else tolerance
        emb = np.asarray(embedding, np.float32).reshape(-1)
        mat, names = self.gallery.host_arrays()
        with self._lock:
            self.metrics["compare_calls"] += 1
        if not len(names):
            return {
                "matches": [],
                "best_match": None,
                "match_found": False,
                "gallery_size": 0,
                "processing_time": time.perf_counter() - t0,
            }
        dists = np.linalg.norm(mat - emb[None, :], axis=1)
        order = np.argsort(dists)
        matches = []
        for i in order:
            if dists[i] > tol:
                break
            matches.append(self._match_entry(names[i], float(dists[i])))
        best_i = int(order[0])
        best = self._match_entry(names[best_i], float(dists[best_i]))
        dt = time.perf_counter() - t0
        with self._lock:
            self.metrics["compare_time_total"] += dt
        return {
            "matches": matches,
            "best_match": best,
            "match_found": float(dists[best_i]) <= tol,
            "gallery_size": len(names),
            "tolerance": tol,
            "processing_time": dt,
        }

    @staticmethod
    def _match_entry(name: str, distance: float) -> dict:
        return {
            "target": name,
            "distance": round(distance, 4),
            "confidence": confidence_level(distance),
            "confidence_score": calibrate_confidence(distance),
        }

    def compare_image(self, image: np.ndarray, tolerance: float | None = None) -> dict:
        enc = self.encode_image(image)
        if not enc["success"] or enc["face_count"] == 0:
            return {
                "success": enc["success"],
                "face_count": enc["face_count"],
                "results": [],
                "message": enc.get("message", "No face detected"),
            }
        results = [
            self.compare_embedding(face["embedding"], tolerance)
            for face in enc["faces"]
        ]
        return {"success": True, "face_count": enc["face_count"], "results": results}

    def find_k_nearest_targets(self, embedding: np.ndarray, k: int = 5) -> list:
        """face_service.py:590-612."""
        emb = np.asarray(embedding, np.float32).reshape(-1)
        mat, names = self.gallery.host_arrays()
        if not len(names):
            return []
        dists = np.linalg.norm(mat - emb[None, :], axis=1)
        idx = find_k_nearest(dists, k)
        return [self._match_entry(names[i], float(dists[i])) for i in idx]

    def cluster_faces(self, distance_threshold: float = 0.6) -> dict:
        """Greedy single-link clustering (face_service.py:552-585)."""
        mat, names = self.gallery.host_arrays()
        if len(names) < 2:
            return {"cluster_0": list(names)}
        clusters: dict[str, list] = {}
        assigned: set[int] = set()
        cid = 0
        for i in range(len(names)):
            if i in assigned:
                continue
            members = [names[i]]
            assigned.add(i)
            dists = np.linalg.norm(mat - mat[i][None, :], axis=1)
            for j in range(len(names)):
                if j in assigned or j == i:
                    continue
                if dists[j] <= distance_threshold:
                    members.append(names[j])
                    assigned.add(j)
            clusters[f"cluster_{cid}"] = members
            cid += 1
        return clusters

    # ------------------------------------------------------------------
    # metrics / health
    # ------------------------------------------------------------------
    def get_quality_statistics(self) -> dict:
        hist = list(self._quality_history)
        if not hist:
            return {"samples": 0}
        scores = [h["score"] for h in hist]
        return {
            "samples": len(hist),
            "average_score": round(sum(scores) / len(scores), 2),
            "min_score": round(min(scores), 2),
            "max_score": round(max(scores), 2),
        }

    def get_performance_metrics(self) -> dict:
        with self._lock:
            m = dict(self.metrics)
        calls = max(m["encode_calls"] - m["encode_cache_hits"], 1)
        return {
            **m,
            "average_encode_time": round(m["encode_time_total"] / calls, 4),
            "average_compare_time": round(
                m["compare_time_total"] / max(m["compare_calls"], 1), 6
            ),
            "cache_hit_rate": round(
                m["encode_cache_hits"] / max(m["encode_calls"], 1), 3
            ),
            "engine": self.engine.metrics.as_dict(),
        }

    def clear_cache(self) -> int:
        with self._lock:
            n = len(self._cache)
            self._cache.clear()
        return n

    def health_check(self) -> dict:
        return {
            "status": "healthy",
            "gallery_size": len(self.gallery),
            "gallery_capacity": self.gallery.capacity,
            "embed_dim": self.gallery.embed_dim,
            "cache_entries": len(self._cache),
            "storage": self._faces_coll is not None,
            "encryption": self._cipher is not None and self._cipher.available,
        }
