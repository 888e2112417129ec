"""Face management routes — reference ``backend/app/routes/face.py`` contract
(15 endpoints under /face): the full enrollment pipeline with sanitization,
size/type limits, duplicate handling, single-face enforcement, quality gating,
encrypted storage; plus list/detail/update/delete, compare, search, stats,
similar, export, bulk delete, validate, health, clear.
"""

from __future__ import annotations

import asyncio
import io
import json
import os
import re
from datetime import datetime

import numpy as np

from frp_tpu_torch.api.http import (
    parse_float_param,
    parse_int_param,
    HTTPError,
    Request,
    Response,
    StreamResponse,
    json_response,
)
from frp_tpu_torch.utils.logger import get_logger

logger = get_logger("frp.api.face")

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

ALLOWED_TYPES = {"image/jpeg", "image/png", "image/webp", "image/bmp"}
ALLOWED_EXT = {".jpg", ".jpeg", ".png", ".webp", ".bmp"}


def sanitize_name(name: str) -> str:
    """Filename/target sanitization (reference face.py:62-70)."""
    name = name.strip().replace(" ", "_")
    name = re.sub(r"[^A-Za-z0-9._-]", "", name)
    return name[:128]


def decode_image(data: bytes) -> np.ndarray:
    """JPEG/PNG bytes -> RGB uint8 array (host, cv2 C++)."""
    if cv2 is not None:
        arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if arr is None:
            raise HTTPError(400, "could not decode image")
        return cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
    try:
        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception as e:
        raise HTTPError(400, f"could not decode image: {e}")


def register(router, ctx):
    svc = ctx.face_service
    max_bytes = ctx.cfg.upload_max_mb * 1024 * 1024

    def _validate_upload(upload, target: str):
        if not target:
            raise HTTPError(422, "target name is required")
        if upload.size > max_bytes:
            raise HTTPError(413, f"file exceeds {ctx.cfg.upload_max_mb} MB limit")
        ext_ok = any(upload.filename.lower().endswith(e) for e in ALLOWED_EXT)
        if upload.content_type not in ALLOWED_TYPES and not ext_ok:
            raise HTTPError(400, f"unsupported file type {upload.content_type}")

    def _enroll(image: np.ndarray, target: str, min_quality: float, override: bool):
        """The enrollment core (reference face.py:114-331 semantics)."""
        overridden = target in svc.get_all_targets()
        if overridden and not override:
            raise HTTPError(
                409, f"target '{target}' already exists (pass override=true to replace)"
            )
        enc = svc.encode_image(image)
        if not enc["success"]:
            raise HTTPError(500, enc.get("message", "encoding failed"))
        if enc["face_count"] == 0:
            raise HTTPError(400, "no face detected in image")
        if enc["face_count"] > 1:
            raise HTTPError(
                400,
                f"multiple faces detected ({enc['face_count']}); upload exactly one face",
            )
        face = enc["faces"][0]
        box = face["box"]
        # quality gate uses the exact host formula replica (face.py:221-238)
        loc = (int(box[1]), int(box[2]), int(box[3]), int(box[0]))  # t, r, b, l
        quality = svc.assess_face_quality(image, loc)
        if quality["score"] < min_quality:
            raise HTTPError(
                400,
                json.dumps(
                    {
                        "message": f"face quality {quality['score']} below minimum {min_quality}",
                        "quality": quality,
                        "recommendations": quality["issues"],
                    }
                ),
            )
        stored = svc.store_face(target, face["embedding"])
        meta = {
            "target": target,
            "quality": quality,
            "detection_score": face["score"],
            "fake_prob": face.get("fake_prob"),
        }
        if ctx.db is not None:
            ctx.db["faces"].update_one(
                {"target": target},
                {"$set": {"quality_score": quality["score"], "detection_score": face["score"]}},
                upsert=True,
            )
        from frp_tpu_torch.utils.logger import create_target_log_files

        create_target_log_files(target, ctx.cfg.log_dir)
        # reference envelope (face.py:290-315): the React app keys off
        # status === "success" (App.jsx:97, FaceUpload.jsx:247)
        return {
            "status": "success",
            "message": f"Face successfully enrolled for '{target}'",
            "target": target,
            "overridden": overridden,
            "quality": {
                "score": round(quality["score"], 2),
                "rating": (
                    "excellent" if quality["score"] >= 80
                    else "good" if quality["score"] >= 60
                    else "acceptable"
                ),
                "issues": quality["issues"] or None,
            },
            "metadata": {
                "resolution": f"{image.shape[1]}x{image.shape[0]}",
            },
            "timestamp": datetime.now().isoformat(),
            # extensions
            "success": True,
            "face_count": 1,
            "quality_detail": quality,
            "warning": stored.get("warning"),
            "processing_time": enc["processing_time"],
        }

    @router.post("/face/upload")
    async def upload_face(request: Request):
        fields, files = request.form()
        upload = files.get("file") or files.get("image")
        if upload is None:
            raise HTTPError(422, "multipart field 'file' is required")
        # reference face.py:117,133: target_name arrives as a QUERY param and
        # defaults to the filename stem; the reference frontend additionally
        # posts target_name as a FORM field (App.jsx:91, FaceUpload.jsx:169) —
        # accept every shape so both clients work.
        target = sanitize_name(
            request.query.get("target_name")
            or fields.get("target_name")
            or fields.get("target")
            or fields.get("name")
            or (upload.filename or "").rsplit(".", 1)[0]
        )
        _validate_upload(upload, target)
        # override / min_quality / save_raw are QUERY params in the reference
        # (face.py:117-121); form fields kept as an extension
        min_quality = parse_float_param(
            request.query.get("min_quality") or fields.get("min_quality"),
            "min_quality", ctx.cfg.min_face_quality,
        )
        override = (
            request.query.get("override") or fields.get("override", "")
        ).lower() in ("1", "true", "yes")
        save_raw = (
            request.query.get("save_raw") or fields.get("save_raw", "")
        ).lower() in ("1", "true", "yes")
        # cv2.imdecode of a 10 MB upload stalls the event loop
        # (and every socket.io heartbeat) if run inline
        image = await asyncio.to_thread(decode_image, upload.data)
        result = await asyncio.to_thread(_enroll, image, target, min_quality, override)
        safe_filename = sanitize_name((upload.filename or target).rsplit(".", 1)[0])
        ext = os.path.splitext(upload.filename or "")[1] or ".jpg"
        result["filename"] = safe_filename + ext
        result["metadata"]["file_size_kb"] = round(upload.size / 1024, 2)
        if save_raw:
            # reference face.py:168-174: persist the raw upload
            raw_dir = ctx.cfg.uploads_path()  # UPLOAD_DIR/UPLOADS_DIR/FACE_UPLOAD_DIR
            os.makedirs(raw_dir, exist_ok=True)
            raw_path = os.path.join(raw_dir, safe_filename + ext)
            with open(raw_path, "wb") as f:
                f.write(upload.data)
            result["raw_saved"] = raw_path
        return json_response(result, 200)

    @router.post("/face/upload/batch")
    async def upload_batch(request: Request):
        fields, files = request.form()
        if len(files) > 20:  # reference face.py:337-444 cap
            raise HTTPError(422, "at most 20 files per batch")
        min_quality = parse_float_param(
            fields.get("min_quality"), "min_quality", ctx.cfg.min_face_quality
        )
        override = fields.get("override", "").lower() in ("1", "true", "yes")
        results = []
        for name, upload in files.items():
            target = sanitize_name(
                fields.get(f"target_{name}")
                or upload.filename.rsplit(".", 1)[0]
                or name
            )
            try:
                _validate_upload(upload, target)
                image = await asyncio.to_thread(decode_image, upload.data)
                res = await asyncio.to_thread(_enroll, image, target, min_quality, override)
                results.append(res)
            except HTTPError as e:
                results.append({"success": False, "target": target, "error": e.detail})
        ok = sum(1 for r in results if r.get("success"))
        return json_response(
            {"total": len(results), "successful": ok, "failed": len(results) - ok,
             "results": results}
        )

    @router.get("/face/list")
    async def face_list(request: Request):
        targets = svc.get_all_targets()
        sort = request.query.get("sort", "name")
        include_meta = request.query_bool("metadata")
        entries = []
        for t in targets:
            entry = {"target": t}
            if include_meta and ctx.db is not None:
                doc = ctx.db["faces"].find_one({"target": t}) or {}
                entry["quality_score"] = doc.get("quality_score")
                entry["updated_at"] = doc.get("updated_at")
            entries.append(entry)
        if sort == "name":
            entries.sort(key=lambda e: e["target"])
        # reference envelope (face.py:450-500): status + count + total +
        # targets (plain names; FaceUpload.jsx:60 reads payload.targets);
        # `faces` carries the per-target metadata entries as in the
        # metadata=true branch
        return json_response(
            {
                "status": "success",
                "count": len(entries),
                "total": len(targets),
                "targets": [e["target"] for e in entries],
                "faces": entries,
            }
        )

    @router.get("/face/detail/{target}")
    async def face_detail(request: Request):
        target = request.path_params["target"]
        if target not in svc.get_all_targets():
            raise HTTPError(404, f"target '{target}' not found")
        doc = (ctx.db["faces"].find_one({"target": target}) or {}) if ctx.db is not None else {}
        doc.pop("embedding", None)
        doc.pop("_id", None)
        knn = svc.find_k_nearest_targets(svc.gallery.get(target), k=4)
        return json_response(
            {"target": target, "metadata": doc,
             "similar": [m for m in knn if m["target"] != target]}
        )

    @router.delete("/face/delete/{target}")
    async def face_delete(request: Request):
        target = request.path_params["target"]
        result = svc.delete_face(target)
        if not result["success"]:
            raise HTTPError(404, result["message"])
        # reference envelope (face.py:565): FaceUpload.jsx:126 keys off
        # payload.status === "success" and alerts payload.message
        return json_response(
            {
                "status": "success",
                "message": result.get("message") or f"Face '{target}' deleted",
                "target": target,
                "logs_deleted": result.get("logs_deleted", False),
                **result,
            }
        )

    @router.patch("/face/update/{target}")
    async def face_update(request: Request):
        """Rename = re-store under new name + delete old (face.py:577-644)."""
        target = request.path_params["target"]
        body = request.json() or {}
        new_name = sanitize_name(body.get("new_name", ""))
        if not new_name:
            raise HTTPError(422, "'new_name' is required")
        emb = svc.gallery.get(target)
        if emb is None:
            raise HTTPError(404, f"target '{target}' not found")
        if new_name in svc.get_all_targets():
            raise HTTPError(409, f"target '{new_name}' already exists")
        svc.store_face(new_name, emb)
        svc.delete_face(target)
        return json_response({"success": True, "old": target, "new": new_name})

    @router.post("/face/compare")
    async def face_compare(request: Request):
        """Upload compare with per-request tolerance (face.py:685-690 mutates
        the service tolerance; here it's a parameter — same behavior, no race)."""
        fields, files = request.form()
        upload = files.get("file") or files.get("image")
        if upload is None:
            raise HTTPError(422, "multipart field 'file' is required")
        if upload.size > max_bytes:
            raise HTTPError(413, "file too large")
        tolerance = parse_float_param(
            request.query.get("threshold") or fields.get("tolerance"),
            "threshold", svc.tolerance,  # reference face.py:653 query param
        )
        top_k = parse_int_param(
            request.query.get("top_k") or fields.get("top_k"), "top_k", 5
        )
        # cv2.imdecode of a 10 MB upload stalls the event loop
        # (and every socket.io heartbeat) if run inline
        image = await asyncio.to_thread(decode_image, upload.data)
        result = await asyncio.to_thread(svc.compare_image, image, tolerance)
        if not result["success"]:
            raise HTTPError(400, result.get("message", "compare failed"))
        # reference envelope (face.py:697-705) around the first face's
        # comparisons; `comparisons` (target/match/distance) is additive so
        # the client's results table actually renders (FaceUpload.jsx:497-546
        # reads .comparisons, which the reference never supplies)
        first = result["results"][0] if result["results"] else {}
        # entries in `matches` are below tolerance by construction
        top_matches = [
            {**m, "match": True} for m in list(first.get("matches", []))[:top_k]
        ]
        best = first.get("best_match")
        comparisons = top_matches or (
            [{**best, "match": bool(first.get("match_found"))}] if best else []
        )
        return json_response(
            {
                "status": "success",
                "filename": upload.filename,
                "threshold": tolerance,
                "total_faces_checked": first.get("gallery_size", 0),
                "matches_found": len(top_matches),
                "top_matches": top_matches,
                "all_comparisons": None if top_matches else comparisons,
                "comparisons": comparisons,
                **result,  # extensions: success/face_count/results
            }
        )

    @router.get("/face/search")
    async def face_search(request: Request):
        q = request.query.get("q", "").lower()
        matches = [t for t in svc.get_all_targets() if q in t.lower()]
        return json_response({"query": q, "count": len(matches), "matches": matches})

    @router.get("/face/stats")
    async def face_stats(request: Request):
        return json_response(
            {
                "total_faces": len(svc.gallery),
                "quality": svc.get_quality_statistics(),
                "performance": svc.get_performance_metrics(),
                "clusters": {k: len(v) for k, v in svc.cluster_faces().items()},
            }
        )

    @router.get("/face/similar/{target}")
    async def face_similar(request: Request):
        target = request.path_params["target"]
        emb = svc.gallery.get(target)
        if emb is None:
            raise HTTPError(404, f"target '{target}' not found")
        k = request.query_int("k", 5)
        knn = svc.find_k_nearest_targets(emb, k=k + 1)
        return json_response(
            {"target": target, "similar": [m for m in knn if m["target"] != target][:k]}
        )

    @router.get("/face/export")
    async def face_export(request: Request):
        fmt = request.query.get("format", "json")
        targets = svc.get_all_targets()
        rows = []
        for t in targets:
            doc = (ctx.db["faces"].find_one({"target": t}) or {}) if ctx.db is not None else {}
            rows.append(
                {"target": t, "quality_score": doc.get("quality_score"),
                 "updated_at": doc.get("updated_at")}
            )
        if fmt == "csv":
            async def gen():
                yield b"target,quality_score,updated_at\n"
                for r in rows:
                    yield (
                        f"{r['target']},{r['quality_score'] or ''},{r['updated_at'] or ''}\n"
                    ).encode()

            return StreamResponse(
                gen(), "text/csv",
                headers={"Content-Disposition": "attachment; filename=faces.csv"},
            )
        return json_response({"count": len(rows), "faces": rows})

    @router.post("/face/delete/bulk")
    async def face_bulk_delete(request: Request):
        body = request.json() or {}
        targets = body.get("targets", [])
        if not isinstance(targets, list) or len(targets) > 50:  # face.py:886-931
            raise HTTPError(422, "provide up to 50 targets")
        results = {t: svc.delete_face(t)["success"] for t in targets}
        return json_response(
            {"deleted": sum(results.values()), "results": results}
        )

    @router.post("/face/validate")
    async def face_validate(request: Request):
        """Dry-run quality check, no storage (face.py:937-1023)."""
        fields, files = request.form()
        upload = files.get("file") or files.get("image")
        if upload is None:
            raise HTTPError(422, "multipart field 'file' is required")
        # cv2.imdecode of a 10 MB upload stalls the event loop
        # (and every socket.io heartbeat) if run inline
        image = await asyncio.to_thread(decode_image, upload.data)
        enc = await asyncio.to_thread(svc.encode_image, image, False)
        if enc["face_count"] == 0:
            return json_response(
                {"valid": False, "face_count": 0, "message": "no face detected"}
            )
        face = enc["faces"][0]
        box = face["box"]
        quality = svc.assess_face_quality(
            image, (int(box[1]), int(box[2]), int(box[3]), int(box[0]))
        )
        return json_response(
            {
                "valid": enc["face_count"] == 1
                and quality["score"] >= ctx.cfg.min_face_quality,
                "face_count": enc["face_count"],
                "quality": quality,
                "would_pass_quality_gate": quality["score"] >= ctx.cfg.min_face_quality,
            }
        )

    @router.get("/face/health")
    async def face_health(request: Request):
        return json_response(svc.health_check())

    @router.delete("/face/clear")
    async def face_clear(request: Request):
        if request.query.get("confirm") != "CONFIRM_DELETE_ALL":  # face.py:1070-1102
            raise HTTPError(400, "pass confirm=CONFIRM_DELETE_ALL to wipe the gallery")
        targets = svc.get_all_targets()
        for t in targets:
            svc.delete_face(t)
        return json_response({"success": True, "deleted": len(targets)})
