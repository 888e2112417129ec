"""Async job routes (port of ``frp_tpu/api/routes/async_tasks.py``) —
reference ``backend/app/routes/async_tasks.py`` contract, actually mounted
and actually working (the reference leaves the router unmounted and crashes
on a missing import, SURVEY.md section 3.6): POST /async/face/search
enqueues a device-batched search; GET /async/jobs/{id} polls; job lifecycle
events stream over Socket.IO.
"""

from __future__ import annotations

import asyncio

from frp_tpu_torch.api.http import HTTPError, parse_float_param, Request, json_response
from frp_tpu_torch.api.routes.face import decode_image


def register(router, ctx):
    mgr = ctx.async_tasks

    @router.post("/async/face/search")
    async def async_face_search(request: Request):
        fields, files = request.form()
        upload = files.get("file") or files.get("image")
        if upload is None:
            raise HTTPError(422, "multipart field 'file' is required")
        if len(upload.data) > ctx.cfg.async_max_upload_bytes:
            # ASYNC_MAX_UPLOAD_BYTES (reference async_tasks.py upload cap)
            raise HTTPError(413, "file too large for async search "
                            f"(limit {ctx.cfg.async_max_upload_bytes} bytes)")
        tolerance = parse_float_param(
            fields.get("tolerance"), "tolerance", ctx.cfg.face_tolerance
        )
        image = await asyncio.to_thread(decode_image, upload.data)
        job = mgr.enqueue_face_search(
            image, tolerance, meta={"filename": upload.filename}
        )
        return json_response(job, 202)

    @router.get("/async/jobs/{job_id}")
    async def get_job(request: Request):
        job = mgr.get_job(request.path_params["job_id"])
        if job is None:
            raise HTTPError(404, "job not found")
        return json_response(job)

    @router.get("/async/jobs")
    async def list_jobs(request: Request):
        return json_response(
            {"jobs": mgr.list_jobs(request.query.get("status")), "stats": mgr.stats()}
        )
