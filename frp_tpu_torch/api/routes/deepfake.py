"""Deepfake routes (port of ``frp_tpu/api/routes/deepfake.py``) — reference
``backend/app/routes/deepfake.py`` contract (15 endpoints under /deepfake)
plus /deepfake/detect-image, which the reference frontend calls but the
reference backend never implemented (api.js:239; SURVEY.md "defects to
fix").
"""

from __future__ import annotations

import asyncio
import os
import tempfile

from frp_tpu_torch.api.http import HTTPError, parse_float_param, Request, StreamResponse, json_response
from frp_tpu_torch.api.routes.face import decode_image

VIDEO_TYPES = {"video/mp4", "video/avi", "video/x-msvideo", "video/quicktime", "video/webm"}
VIDEO_EXT = {".mp4", ".avi", ".mov", ".webm", ".mkv"}
MAX_VIDEO_MB = 100


def register(router, ctx):
    df = ctx.deepfake

    async def _save_temp_video(upload) -> str:
        if upload.size > MAX_VIDEO_MB * 1024 * 1024:
            raise HTTPError(413, f"video exceeds {MAX_VIDEO_MB} MB")
        ext_ok = any(upload.filename.lower().endswith(e) for e in VIDEO_EXT)
        if upload.content_type not in VIDEO_TYPES and not ext_ok:
            raise HTTPError(400, f"unsupported video type {upload.content_type}")
        tmpdir = ctx.cfg.deepfake_uploads_path()  # DEEPFAKE_UPLOAD_DIR
        os.makedirs(tmpdir, exist_ok=True)
        fd, path = tempfile.mkstemp(dir=tmpdir, suffix=os.path.splitext(upload.filename)[1] or ".mp4")

        def _write():  # up to 100 MB — off the event loop
            with os.fdopen(fd, "wb") as f:
                f.write(upload.data)

        await asyncio.to_thread(_write)
        return path

    @router.post("/deepfake/detect")
    async def detect(request: Request):
        fields, files = request.form()
        upload = files.get("file") or files.get("video")
        if upload is None:
            raise HTTPError(422, "multipart field 'file' is required")
        path = await _save_temp_video(upload)
        try:
            threshold = parse_float_param(
                fields.get("threshold"), "threshold", ctx.cfg.deepfake_threshold
            )
            random_sampling = fields.get("random_sampling", "").lower() in ("1", "true")
            result = await asyncio.to_thread(
                df.process_video_cached, path,
                random_sampling=random_sampling, threshold=threshold,
            )
            return json_response(result)
        finally:
            try:
                os.remove(path)
            except OSError:
                pass

    @router.post("/deepfake/detect-image")
    async def detect_image(request: Request):
        """Single-image spoof check — called by the frontend (api.js:239) but
        missing from the reference backend; implemented here."""
        fields, files = request.form()
        upload = files.get("file") or files.get("image")
        if upload is None:
            raise HTTPError(422, "multipart field 'file' is required")
        image = await asyncio.to_thread(decode_image, upload.data)  # RGB
        bgr = image[..., ::-1]
        results = await asyncio.to_thread(df.classify_frames, [bgr])
        r = results[0]
        threshold = parse_float_param(
            fields.get("threshold"), "threshold", ctx.cfg.deepfake_threshold
        )
        if r["fake_prob"] is None:
            return json_response({"result": "no_faces", "faces": 0})
        return json_response(
            {
                "result": "fake" if r["fake_prob"] >= threshold else "real",
                "fake_probability": round(r["fake_prob"], 4),
                "faces": r["faces"],
                "threshold": threshold,
                "model_trained": df.weights_loaded,
            }
        )

    @router.get("/deepfake/cctv")
    async def cctv(request: Request):
        """Live multi-camera sweep (reference deepfake.py:408-477)."""
        max_frames = request.query_int("max_frames", 3)
        result = await asyncio.to_thread(
            df.sweep_cameras, ctx.cameras.all(), max_frames
        )
        return json_response(result)

    @router.get("/deepfake/history")
    async def history(request: Request):
        limit = request.query_int("limit", 100)
        return json_response({"history": df.get_history(limit)})

    @router.get("/deepfake/stats")
    async def stats(request: Request):
        return json_response(df.get_statistics())

    @router.get("/deepfake/export")
    async def export(request: Request):
        fmt = request.query.get("format", "json")
        items = df.get_history(1000)
        if fmt == "csv":
            async def gen():
                yield b"result,confidence,timestamp,processing_time\n"
                for h in items:
                    yield (
                        f"{h['result']},{h['confidence']},{h['timestamp']},"
                        f"{h['processing_time']}\n"
                    ).encode()

            return StreamResponse(gen(), "text/csv")
        return json_response({"count": len(items), "history": items})

    @router.get("/deepfake/model/info")
    async def model_info(request: Request):
        return json_response(df.model_info())

    @router.get("/deepfake/health")
    async def health(request: Request):
        return json_response(df.health_check())

    @router.post("/deepfake/batch")
    async def batch(request: Request):
        fields, files = request.form()
        if len(files) > 10:  # reference deepfake.py:665-732 cap
            raise HTTPError(422, "at most 10 videos per batch")
        results = []
        for name, upload in files.items():
            try:
                path = await _save_temp_video(upload)
                try:
                    r = await asyncio.to_thread(df.process_video_cached, path)
                    results.append({"file": upload.filename, **r})
                finally:
                    try:
                        os.remove(path)
                    except OSError:
                        pass
            except HTTPError as e:
                results.append({"file": upload.filename, "error": e.detail})
        return json_response({"count": len(results), "results": results})

    @router.delete("/deepfake/history")
    async def clear_history(request: Request):
        """Reference contract: DELETE /deepfake/history (deepfake.py:535)."""
        return json_response({"success": True, "cleared": df.clear_history()})

    @router.post("/deepfake/stats/reset")
    async def stats_reset(request: Request):
        """Reference contract: POST /deepfake/stats/reset (deepfake.py:795)."""
        return json_response({"success": True, "stats": df.reset_stats()})

    @router.get("/deepfake/cache/info")
    async def cache_info(request: Request):
        return json_response(df.cache_info())

    async def _cache_clear(request: Request):
        return json_response({"cleared": df.clear_cache()})

    # Reference contract is DELETE /deepfake/cache (deepfake.py:758); the
    # POST /cache/clear variant is kept as an extension.
    router.delete("/deepfake/cache")(_cache_clear)
    router.post("/deepfake/cache/clear")(_cache_clear)

    @router.get("/deepfake/config")
    async def config(request: Request):
        return json_response(
            {
                "max_frames": df.max_frames,
                "threshold": df.threshold,
                "cache_ttl": df.cache_ttl,
                "supported_formats": sorted(VIDEO_EXT),
            }
        )

    @router.get("/deepfake/formats")
    async def formats(request: Request):
        return json_response({"video": sorted(VIDEO_EXT), "max_size_mb": MAX_VIDEO_MB})

    @router.post("/deepfake/validate")
    async def validate(request: Request):
        """Video probe without analysis (reference deepfake.py:828-881)."""
        fields, files = request.form()
        upload = files.get("file") or files.get("video")
        if upload is None:
            raise HTTPError(422, "multipart field 'file' is required")
        path = await _save_temp_video(upload)
        try:
            info = await asyncio.to_thread(df.probe_video, path)
            estimated = (info["frame_count"] / max(df.max_frames, 1)) * 0.1
            return json_response(
                {"valid": True, "video_info": info,
                 "estimated_processing_time": round(min(estimated, 60.0), 2)}
            )
        except (ValueError, RuntimeError) as e:
            return json_response({"valid": False, "error": str(e)})
        finally:
            try:
                os.remove(path)
            except OSError:
                pass
