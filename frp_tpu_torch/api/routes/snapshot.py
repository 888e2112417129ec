"""Snapshot route (port of ``frp_tpu/api/routes/snapshot.py``) — reference
``backend/app/routes/snapshot.py``: GET /api/camera/{cam_id}/snapshot with
cache -> live-capture -> placeholder chain, ETag/304 conditional handling,
Cache-Control, and optional background enhancement (?enhance=true).
"""

from __future__ import annotations

import asyncio
import hashlib

from frp_tpu_torch.api.http import HTTPError, Request, Response
from frp_tpu_torch.platform.enhancer import enhance_snapshot_bytes

PLACEHOLDER_SVG = (
    b'<svg xmlns="http://www.w3.org/2000/svg" width="320" height="180">'
    b'<rect width="100%" height="100%" fill="#222"/>'
    b'<text x="50%" y="50%" fill="#888" text-anchor="middle" '
    b'font-family="sans-serif">no snapshot</text></svg>'
)


def register(router, ctx):
    def _etag(data: bytes) -> str:
        return '"' + hashlib.sha1(data).hexdigest()[:16] + '"'

    @router.get("/api/camera/{cam_id}/snapshot")
    async def api_snapshot(request: Request):
        try:
            cam_id = int(request.path_params["cam_id"])
        except ValueError:
            raise HTTPError(422, "camera id must be an integer")
        key = f"cam:{cam_id}"
        data = ctx.thumbnails.get(key)
        if data is None:
            cam = ctx.cameras.get(cam_id)
            if cam is not None:
                ok, frame = await asyncio.to_thread(cam.read)
                if ok and frame is not None:
                    try:
                        import cv2

                        ok2, buf = cv2.imencode(".jpg", frame)
                        if ok2:
                            data = buf.tobytes()
                            ctx.thumbnails.set(key, data)
                    except ImportError:
                        pass
        if data is None:
            # X-Placeholder: the grid client keys off it (reference
            # snapshot.py:171, CameraGrid.jsx:137-147)
            return Response(
                PLACEHOLDER_SVG, 404, "image/svg+xml",
                {"Cache-Control": "no-cache, no-store", "X-Placeholder": "1"},
            )

        etag = _etag(data)
        if request.headers.get("if-none-match") == etag:
            return Response(b"", 304, "image/jpeg", {"ETag": etag})

        headers = {"ETag": etag,
                   "Cache-Control": ctx.cfg.snapshot_cache_control}
        if request.query_bool("enhance"):
            async def enhance_task():
                enhanced = await asyncio.to_thread(
                    enhance_snapshot_bytes, data,
                    upscale=ctx.cfg.enhancer_upscale,
                    max_pixels=ctx.cfg.enhancer_max_pixels,
                    sharpen=ctx.cfg.enhancer_sharpen,
                    quality=ctx.cfg.enhancer_jpeg_quality)
                if enhanced:
                    ctx.thumbnails.set(key, enhanced)

            asyncio.get_running_loop().create_task(enhance_task())
            headers["X-Enhance-Requested"] = "1"  # reference snapshot.py:116,144

        return Response(data, 200, "image/jpeg", headers)
