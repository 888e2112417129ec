"""Camera routes — reference ``backend/app/routes/camera.py`` contract
(18 endpoints under /camera), re-cored on the batched device pipeline:
the scan path (GET /camera/alerts, reference :284-391) grabs one frame per
camera, letterboxes them into ONE device batch, runs the engine's
detect->embed->match stages, then feeds tracking + alert services — replacing
the reference's per-camera thread pool (:277-306). A copy of
``frp_tpu/api/routes/camera.py`` on the port's engine; one addition: the
scan times its parts into the context's ``StageTimers`` (``scan.read``,
``scan.letterbox``, ``scan.encode``, ``scan.submit`` and ``scan.fetch``
with delta transfer, else ``scan.device``, and ``scan.track``), which
``GET /debug/timers`` reports.
"""

from __future__ import annotations

import asyncio
import os
import threading
import time

import numpy as np

from frp_tpu_torch.api.http import HTTPError, Request, Response, StreamResponse, json_response
from frp_tpu_torch.engine.batching import (
    active_rows_for,
    build_batch,
    build_batch_i420_cached,
    delta_hints_for,
    unmap_results,
)
from frp_tpu_torch.utils.logger import get_logger

logger = get_logger("frp.api.camera")

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _jpeg(frame) -> bytes | None:
    if cv2 is None or frame is None:
        return None
    ok, buf = cv2.imencode(".jpg", frame, [cv2.IMWRITE_JPEG_QUALITY, 80])
    return buf.tobytes() if ok else None


class CameraScanStats:
    """Per-camera FPS/processing bookkeeping (reference camera.py:42-43,
    :261-267, exposed at :655-701)."""

    def __init__(self):
        self.per_camera: dict[int, dict] = {}

    def record(self, cam_id: int, dt: float, faces: int):
        entry = self.per_camera.setdefault(
            cam_id,
            {"scans": 0, "total_time": 0.0, "faces_detected": 0, "last_scan": None},
        )
        entry["scans"] += 1
        entry["total_time"] += dt
        entry["faces_detected"] += faces
        entry["last_scan"] = time.time()

    def summary(self, cam_id: int | None = None) -> dict:
        def fmt(cid, e):
            return {
                "camera_id": cid,
                "scans": e["scans"],
                "average_processing_time": round(e["total_time"] / max(e["scans"], 1), 4),
                "effective_fps": round(e["scans"] / max(e["total_time"], 1e-9), 2),
                "faces_detected": e["faces_detected"],
                "last_scan": e["last_scan"],
            }

        if cam_id is not None:
            e = self.per_camera.get(cam_id)
            return fmt(cam_id, e) if e else {"camera_id": cam_id, "scans": 0}
        return {str(c): fmt(c, e) for c, e in self.per_camera.items()}


def register(router, ctx):
    scan_stats = CameraScanStats()
    # THREAD-level mutex held inside run_scan itself: the background
    # scan_loop (api/main.py) and /camera/alerts call run_scan from
    # different threads — an asyncio lock here would only serialize the
    # HTTP side, leaving concurrent cap.read()/engine dispatch/duplicate
    # alerts when the loop is on
    scan_mutex = threading.Lock()
    last_scan = {"t": 0.0, "digest": None}  # freshest non-dry scan result
    # temporal-delta transfer state for the scan loop (cfg.delta_transfer):
    # only changed I420 blocks cross the host->device wire between scans
    # (engine.submit_encoded; bit-exact; keyframes on shape change).
    # Guarded by scan_mutex with everything else.
    from frp_tpu_torch.engine.batching import DeltaEncoder

    # 128-byte blocks: ~1.9x fewer wire bytes than 256 on moving scenes at
    # the same scatter row count (benchmarks/profile_block_size.py)
    scan_delta = DeltaEncoder(block_bytes=int(
        os.getenv("FRP_DELTA_BLOCK", "128")))
    # change-hint letterbox caches (round 4): full letterbox+I420 of the
    # camera set is the dominant one-core host cost per scan; sources that
    # surface change hints (FrameSource.read_hints) re-letterbox only the
    # dirty bands. Guarded by scan_mutex.
    scan_prep: dict = {}

    def _get_camera(request: Request):
        try:
            cam_id = int(request.path_params["cam_id"])
        except (KeyError, ValueError):
            raise HTTPError(422, "camera id must be an integer")
        cam = ctx.cameras.get(cam_id)
        if cam is None:
            raise HTTPError(404, f"camera {cam_id} not found")
        return cam

    # -- scan core (shared by /alerts and the stream loop) -------------------
    def run_scan(
        threshold: float, frame_skip: int, max_faces: int, dry: bool = False
    ) -> dict:
        """dry=True runs detect->match only (no tracking records, alerts, DB
        writes, or socket events) — used by startup warmup to compile the
        exact serving shapes without side effects. Serialized by scan_mutex:
        callers live on different THREADS (background loop + HTTP handlers),
        and concurrent cap.read()/tracking writes would race."""
        with scan_mutex:
            out = _run_scan_locked(threshold, frame_skip, max_faces, dry)
            if not dry:
                last_scan["t"] = time.time()
                last_scan["digest"] = out
            return out

    def _run_scan_locked(
        threshold: float, frame_skip: int, max_faces: int, dry: bool
    ) -> dict:
        t0 = time.perf_counter()
        timers = ctx.timers
        cams = ctx.cameras.all()
        frames: dict[int, np.ndarray | None] = {}
        hints: dict[int, list | None] = {}
        with timers.track("scan.read"):
            for cam in cams:
                frame = None
                bands: list | None = []
                for _ in range(max(1, frame_skip)):  # read+discard (camera.py:202-209)
                    ok, frame, h = cam.read_with_hints()
                    if not ok:
                        frame = None
                        break
                    # change hints accumulate across the skip reads: the
                    # cache was last updated at the PREVIOUS scan, so every
                    # read's bands since then must be covered (None anywhere
                    # -> full); read_with_hints gives None after another reader's read
                    bands = None if (h is None or bands is None) else bands + list(h)
                frames[cam.id] = frame
                hints[cam.id] = bands
        if not frames:
            return {"alerts": [], "detections": [], "scanned": 0, "processing_time": 0.0}

        fmt = getattr(ctx.engine, "preferred_fmt", "rgb")
        with timers.track("scan.letterbox"):
            if fmt == "yuv420":
                # ship only the letterboxed active rows; the engine's ingest
                # stage pads the dead rows on device (batching.active_rows_for)
                rows = active_rows_for(
                    [f.shape[:2] for f in frames.values() if f is not None],
                    ctx.cfg.det_size,
                ) if any(f is not None for f in frames.values()) else None
                batch, meta = build_batch_i420_cached(
                    frames, ctx.cfg.det_size, state=scan_prep, hints=hints,
                    active_rows=rows,
                )
            else:
                batch, meta = build_batch(frames, ctx.cfg.det_size)
        if (
            fmt == "yuv420"
            and getattr(ctx.cfg, "delta_transfer", False)
            and hasattr(ctx.engine, "submit_encoded")
        ):
            with timers.track("scan.encode"):
                payload = scan_delta.encode(
                    batch, hints=delta_hints_for(scan_prep, scan_delta.block))
            t_dev = time.perf_counter()
            try:
                with timers.track("scan.submit"):
                    handle = ctx.engine.submit_encoded(
                        payload, tolerance=threshold, packed=False)
                with timers.track("scan.fetch"):
                    out = ctx.engine.fetch(handle)
            except Exception:
                # encode() already advanced the encoder's previous-frame
                # state; a failed submit leaves the device's resident batch
                # behind it, and every later delta would silently
                # reconstruct stale pixels. Reset -> next scan ships a raw
                # keyframe, which also refreshes the device state.
                scan_delta.reset()
                raise
            out["processing_time"] = time.perf_counter() - t_dev
        else:
            with timers.track("scan.device"):
                out = ctx.engine.process_frames(batch, tolerance=threshold, fmt=fmt)
        if dry:  # shapes compiled; skip every side effect
            return {
                "alerts": [], "detections": [], "scanned": len(frames),
                "processing_time": round(time.perf_counter() - t0, 4),
                "device_time": round(out["processing_time"], 4),
            }

        with timers.track("scan.track"):
            detections, new_alerts = _track(out, meta, len(frames), max_faces)
        dt = time.perf_counter() - t0
        return {
            "alerts": new_alerts,
            "detections": detections,
            "scanned": len(frames),
            "processing_time": round(dt, 4),
            "device_time": round(out["processing_time"], 4),
        }

    def _track(out: dict, meta, n_frames: int, max_faces: int) -> tuple[list, list]:
        """The scan's matches -> tracking records and alerts; returns
        (detections, new alerts)."""
        per_camera = unmap_results(out, meta)
        detections = []
        new_alerts = []
        gallery = ctx.engine.gallery
        # resolve identities against the names snapshot tied to the gallery
        # arrays THIS scan matched on (swap-remove reassigns slot indices;
        # live name_of() could attribute the face to whoever replaced the
        # removed identity). FakeEngine results carry no snapshot -> live.
        names_snap = out.get("gallery_names")
        for cam_result in per_camera:
            cam_id = cam_result["camera_id"]
            faces = cam_result["faces"][:max_faces]
            scan_stats.record(cam_id, out["processing_time"] / max(n_frames, 1), len(faces))
            for face in faces:
                if not face["is_match"]:
                    continue
                bi = face["best_idx"]
                if names_snap is not None:
                    target = names_snap[bi] if 0 <= bi < len(names_snap) else None
                else:
                    target = gallery.name_of(bi)
                if target is None:
                    continue
                distance = face["best_distance"]
                rec = ctx.tracking.record_detection(target, cam_id, distance)
                detection = {
                    "target": target,
                    "camera_id": cam_id,
                    "distance": round(distance, 4),
                    "box": [round(float(v), 1) for v in face["box"]],
                    "score": round(face["score"], 4),
                    "fake_prob": round(face.get("fake_prob", 0.0), 4),
                    "recorded": rec["recorded"],
                }
                detections.append(detection)
                if rec["recorded"]:
                    alert = ctx.alerts.generate_alert(target, cam_id, distance)
                    new_alerts.append(alert)
        return detections, new_alerts

    ctx.run_scan = run_scan  # exposed for the background scan loop / bench

    # -- endpoints ------------------------------------------------------------
    @router.get("/camera/alerts")
    async def camera_alerts(request: Request):
        """The realtime scan (reference camera.py:284-391): detect + match on
        all cameras, record tracking, fire alerts, return the full digest."""
        threshold = request.query_float("threshold", ctx.cfg.face_tolerance)
        frame_skip = request.query_int("frame_skip", ctx.cfg.frame_skip)
        max_faces = request.query_int("max_faces", 10)
        # When the background scan loop is running with these same defaults,
        # reuse its freshest digest instead of queueing ANOTHER scan behind
        # the mutex — on a slow backend the poll endpoint would otherwise
        # starve waiting for the loop's next gap.
        defaults = (
            threshold == ctx.cfg.face_tolerance
            and frame_skip == ctx.cfg.frame_skip
            and max_faces == 10
        )
        prev = last_scan["digest"]
        freshness = max(
            2.0,
            2.0 * ctx.cfg.camera_scan_interval,
            # a slow backend's loop produces digests at scan-duration cadence;
            # the newest available one IS the current state
            3.0 * (prev or {}).get("processing_time", 0.0),
        )
        cached = False
        if defaults and time.time() - last_scan["t"] < freshness:
            scan = last_scan["digest"]
            cached = True
        else:
            scan = await asyncio.to_thread(run_scan, threshold, frame_skip, max_faces)
        all_alerts = ctx.alerts.get_alerts(limit=50)
        # reference envelope (camera.py:367-387, consumed by App.jsx:119-144):
        # alerts grouped one-per-target; "history" = per-person movements;
        # "movement_log" = a LIST derived from current locations.
        grouped: dict = {}
        for alert in all_alerts:
            tgt = alert.get("target")
            if tgt and tgt not in grouped:
                grouped[tgt] = alert
        latest = ctx.alerts.get_latest_alert()
        movements = ctx.tracking.get_all_movements(limit_per_person=10)
        return json_response(
            {
                "status": "success",
                "alerts": list(grouped.values()),
                "history": movements,
                "movement_log": [
                    {
                        "target": person,
                        "camera_id": recs[-1]["camera_id"],
                        "camera_name": recs[-1]["camera_name"],
                        "geo": recs[-1].get("geo"),
                        "timestamp": recs[-1].get("timestamp"),
                    }
                    for person, recs in movements.items()
                    if recs
                ],
                "latest_detection": latest,
                "metadata": {
                    "cameras_scanned": scan["scanned"],
                    "threshold": threshold,
                    "detections": len(scan["detections"]),
                    "processing_time": scan["processing_time"],
                    "device_time": scan.get("device_time"),
                    # when the freshness window serves a prior scan's digest,
                    # say so — processing_time/cameras_scanned describe that
                    # scan, and its alerts must not re-report as new
                    "cached": cached,
                    "digest_age": round(time.time() - last_scan["t"], 3)
                    if cached else 0.0,
                },
                # extensions beyond the reference envelope
                "all_alerts": all_alerts,
                "new_alerts": [] if cached else scan["alerts"],
                "detections": scan["detections"],
                "alert_history": ctx.alerts.history_snapshot(10),
            }
        )

    @router.get("/camera/{cam_id}/feed")
    async def camera_feed(request: Request):
        """MJPEG stream (reference camera.py:73-122)."""
        cam = _get_camera(request)
        fps = min(max(request.query_float("fps", 5.0), 0.2), 30.0)

        async def gen():
            boundary = b"--frame"
            while True:
                ok, frame = await asyncio.to_thread(cam.read)
                if ok and frame is not None:
                    jpeg = _jpeg(frame)
                    if jpeg:
                        yield (
                            boundary
                            + b"\r\nContent-Type: image/jpeg\r\nContent-Length: "
                            + str(len(jpeg)).encode()
                            + b"\r\n\r\n"
                            + jpeg
                            + b"\r\n"
                        )
                await asyncio.sleep(1.0 / fps)

        return StreamResponse(
            gen(), "multipart/x-mixed-replace; boundary=frame"
        )

    @router.get("/camera/{cam_id}/snapshot")
    async def camera_snapshot(request: Request):
        """Single JPEG (reference camera.py:127-166), cached."""
        cam = _get_camera(request)
        key = f"cam:{cam.id}"
        cached = ctx.thumbnails.get(key)
        if cached is not None and not request.query_bool("fresh"):
            return Response(cached, 200, "image/jpeg", {"X-Cache": "hit"})
        ok, frame = await asyncio.to_thread(cam.read)
        if not ok or frame is None:
            raise HTTPError(503, f"camera {cam.id} unavailable")
        jpeg = _jpeg(frame)
        if jpeg is None:
            raise HTTPError(500, "encode failed")
        ctx.thumbnails.set(key, jpeg)
        return Response(jpeg, 200, "image/jpeg", {"X-Cache": "miss"})

    @router.get("/camera/stats")
    async def camera_stats(request: Request):
        return json_response(
            {
                "tracking": ctx.tracking.get_statistics(),
                "alerts": ctx.alerts.get_statistics(),
                "engine": ctx.engine.metrics.as_dict(),
                "cameras": {str(c.id): c.info() for c in ctx.cameras.all()},
            }
        )

    @router.get("/camera/movement/{person}")
    async def movement(request: Request):
        person = request.path_params["person"]
        return json_response(
            {
                "person": person,
                "movements": ctx.tracking.get_movement_history(person),
                "path": ctx.tracking.get_movement_path(person),
                "current_location": ctx.tracking.get_current_locations().get(person),
                "predicted_trajectory": ctx.tracking.get_predicted_trajectory(person),
            }
        )

    @router.get("/camera/analyze/{person}")
    async def analyze(request: Request):
        # reference camera.py:436 envelope: {status, person, analysis}
        person = request.path_params["person"]
        return json_response(
            {"person": person,
             "analysis": ctx.tracking.detect_suspicious_patterns(person)}
        )

    @router.get("/camera/list")
    async def camera_list(request: Request):
        # reference camera.py:468 envelope: {status, count, cameras}
        cams = [c.info() for c in ctx.cameras.all()]
        return json_response({"count": len(cams), "cameras": cams})

    @router.get("/camera/{cam_id}/info")
    async def camera_info(request: Request):
        return json_response(_get_camera(request).info())

    @router.post("/camera/add")
    async def camera_add(request: Request):
        body = request.json() or {}
        if "id" not in body:
            raise HTTPError(422, "'id' is required")
        try:
            cam = ctx.cameras.add(
                int(body["id"]),
                body.get("name", f"Camera {body['id']}"),
                tuple(body.get("geo", (0.0, 0.0))),
                body.get("source", "synthetic"),
            )
        except ValueError as e:
            raise HTTPError(409, str(e))
        ctx.refresh_camera_metadata()
        return json_response({"success": True, "camera": cam.info()}, 201)

    @router.patch("/camera/{cam_id}")
    async def camera_patch(request: Request):
        cam = _get_camera(request)
        body = request.json() or {}
        ctx.cameras.update(
            cam.id,
            name=body.get("name"),
            geo=tuple(body["geo"]) if "geo" in body else None,
            source=body.get("source"),
        )
        ctx.refresh_camera_metadata()
        return json_response({"success": True, "camera": cam.info()})

    @router.delete("/camera/{cam_id}")
    async def camera_delete(request: Request):
        cam = _get_camera(request)
        ctx.cameras.remove(cam.id)
        ctx.refresh_camera_metadata()
        return json_response({"success": True, "deleted": cam.id})

    @router.post("/camera/{cam_id}/restart")
    async def camera_restart(request: Request):
        cam = _get_camera(request)
        ok = await asyncio.to_thread(cam.restart)
        return json_response({"success": ok, "camera": cam.info()})

    async def _camera_restart_all(request: Request):
        results = {}
        for cam in ctx.cameras.all():
            results[str(cam.id)] = await asyncio.to_thread(cam.restart)
        return json_response({"success": True, "results": results})

    # Reference contract is POST /camera/bulk/restart (camera.py:749).
    router.post("/camera/bulk/restart")(_camera_restart_all)
    router.post("/camera/restart/all")(_camera_restart_all)

    @router.get("/camera/{cam_id}/performance")
    async def camera_performance(request: Request):
        cam = _get_camera(request)
        return json_response({**scan_stats.summary(cam.id), "camera": cam.info()})

    async def _global_performance(request: Request):
        return json_response(
            {"per_camera": scan_stats.summary(), "engine": ctx.engine.metrics.as_dict()}
        )

    # Reference contract is GET /camera/performance/all (camera.py:684).
    router.get("/camera/performance/all")(_global_performance)
    router.get("/camera/performance")(_global_performance)

    async def _clear_performance(request: Request):
        scan_stats.per_camera.clear()
        return json_response({"success": True})

    # Reference contract is DELETE /camera/performance/clear (camera.py:785).
    router.delete("/camera/performance/clear")(_clear_performance)
    router.post("/camera/performance/clear")(_clear_performance)

    @router.get("/camera/health")
    async def camera_health(request: Request):
        """Fleet health with live read probes (reference camera.py:706-744)."""
        results = await asyncio.to_thread(ctx.health.probe_all)
        healthy = sum(1 for r in results.values() if r.get("healthy"))
        return json_response(
            {
                "status": "healthy" if healthy == len(results) else "degraded",
                "cameras_total": len(results),
                "cameras_healthy": healthy,
                "cameras": {str(k): v for k, v in results.items()},
            }
        )

    @router.post("/api/camera/ingest")
    async def camera_ingest(request: Request):
        """Frame ingest for push-mode cameras — the endpoint the reference's
        mock_camera_worker POSTs to but the reference never implemented
        (tools/mock_camera_worker.py:19-53; SURVEY.md defects list). Accepts
        multipart 'file' (JPEG/PNG) + 'camera_id'; auto-registers a push
        camera on first use."""
        from frp_tpu_torch.api.routes.face import decode_image
        from frp_tpu_torch.platform.state import PushSource

        fields, files = request.form()
        upload = files.get("file") or files.get("image") or files.get("frame")
        if upload is None:
            raise HTTPError(422, "multipart field 'file' is required")
        try:
            cam_id = int(fields.get("camera_id", fields.get("id", 0)))
        except ValueError:
            raise HTTPError(422, "'camera_id' must be an integer")
        rgb = await asyncio.to_thread(decode_image, upload.data)
        bgr = np.ascontiguousarray(rgb[..., ::-1])
        cam = ctx.cameras.get(cam_id)
        if cam is None:
            cam = ctx.cameras.add(
                cam_id, fields.get("name", f"Push Camera {cam_id}"), source="push"
            )
            ctx.refresh_camera_metadata()
        if not isinstance(cam.source, PushSource):
            raise HTTPError(409, f"camera {cam_id} is not a push-mode camera")
        cam.source.push(bgr)
        cam.healthy = True
        cam.last_seen = time.time()
        return json_response(
            {"success": True, "camera_id": cam_id, "frames_pushed": cam.source.pushed}
        )

    @router.post("/camera/test")
    async def camera_test(request: Request):
        """Connection test for a source spec without registering it
        (reference camera.py:800-824)."""
        body = request.json() or {}
        spec = body.get("source", "synthetic")
        from frp_tpu_torch.platform.state import make_source

        def probe():
            src = make_source(spec)
            try:
                ok, frame = src.read()
                return ok, None if frame is None else list(frame.shape)
            finally:
                src.release()

        ok, shape = await asyncio.to_thread(probe)
        return json_response({"success": ok, "frame_shape": shape, "source": str(spec)})
