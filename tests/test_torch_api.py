"""PyTorch port, the server: the JAX app's route table on the port's router;
the route contract of tests/test_api.py for the camera, face, alerts and
debug routes, each case run on the JAX app and on the port's app with the
same fake engine (a deterministic embedding of the image, in each package's
own gallery); the port's server on a live socket (HTTP, a
multipart upload, the Socket.IO handshake and the alert a scan pushes); the
``python -m frp_tpu_torch.api.main`` entry point; the card as the default
device and a warmup failure that raises."""

import asyncio
import base64
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from frp_tpu.api import http as jhttp
from frp_tpu.api.main import build_app as j_build_app
from frp_tpu.config import load_config as j_load_config
from frp_tpu.platform.context import AppContext as JContext

from frp_tpu_torch.api import http as thttp
from frp_tpu_torch.api import main as tmain
from frp_tpu_torch.api.socketio import read_frame
from frp_tpu_torch.config import load_config
from frp_tpu_torch.engine.gallery import DeviceGallery as TGallery
from frp_tpu_torch.platform.context import AppContext as TContext
from tests.fakes import FakeEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMS = [
    {"id": 0, "name": "Cam A", "geo": (18.5, 73.8), "source": "synthetic:96x64"},
    {"id": 1, "name": "Cam B", "geo": (18.6, 73.9), "source": "synthetic:96x64"},
]


def _port_fake():
    eng = FakeEngine()
    eng.gallery = TGallery(embed_dim=128)
    return eng


class App:
    """One app under test: its router, context and its package's http module
    (Request, HTTPError and the response classes)."""

    def __init__(self, kind, tmp_path, **cfg_kw):
        kw = dict(data_dir=str(tmp_path / "data"), log_dir=str(tmp_path / "logs"),
                  min_face_quality=0.0, **cfg_kw)  # FakeEngine quality is synthetic
        if kind == "jax":
            ctx = JContext(cfg=j_load_config(**kw), engine=FakeEngine(), camera_configs=CAMS)
            self.router, _, self.ctx = j_build_app(ctx)
            self.http = jhttp
        else:
            ctx = TContext(cfg=load_config(**kw), engine=_port_fake(), camera_configs=CAMS)
            self.router, _, self.ctx = tmain.build_app(ctx)
            self.http = thttp

    def call(self, method, path, query=None, json_body=None, body=b"", headers=None):
        headers = dict(headers or {})
        if json_body is not None:
            body = json.dumps(json_body).encode()
            headers["content-type"] = "application/json"
        handler, params = self.router.resolve(method, path)
        assert handler is not None, f"no route for {method} {path}"
        req = self.http.Request(method, path, query or {}, headers, body, params)
        resp = asyncio.run(handler(req))
        if isinstance(resp, self.http.StreamResponse):
            async def drain():
                chunks = []
                async for c in resp.gen:
                    chunks.append(c)
                    if len(chunks) > 20:
                        break
                return b"".join(chunks)

            return resp.status, asyncio.run(drain()), resp
        ctype = resp.content_type == "application/json"
        return resp.status, json.loads(resp.body) if ctype and resp.body else resp.body, resp

    def error(self, method, path, **kw) -> int:
        """The status of the HTTPError a request raises."""
        with pytest.raises(self.http.HTTPError) as e:
            self.call(method, path, **kw)
        return e.value.status


@pytest.fixture(params=["jax", "torch"])
def app(request, tmp_path):
    a = App(request.param, tmp_path)
    yield a
    a.ctx.shutdown()


def _multipart(fields: dict, files: dict) -> tuple[bytes, str]:
    boundary = "testboundary123"
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
             for k, v in fields.items()]
    for k, (fname, data, ctype) in files.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"; '
                     f'filename="{fname}"\r\nContent-Type: {ctype}\r\n\r\n'.encode() + data + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def _jpeg_bytes(value=128) -> bytes:
    import cv2

    return cv2.imencode(".jpg", np.full((64, 64, 3), value, np.uint8))[1].tobytes()


def _upload_args(target, value=128, data=None, **fields):
    body, ctype = _multipart(
        {"target": target, **fields},
        {"file": (f"{target or 'x'}.jpg", data or _jpeg_bytes(value), "image/jpeg")})
    return dict(body=body, headers={"content-type": ctype})


def _upload(app, target, value=128, **fields):
    return app.call("POST", "/face/upload", **_upload_args(target, value, **fields))


# --- root and camera routes ---------------------------------------------------------

def test_root_and_status_envelope(app):
    status, data, _ = app.call("GET", "/")
    assert status == 200 and data["status"] == "running" and data["cameras"] == 2
    status, data, _ = app.call("GET", "/camera/status")
    assert status == 200 and data["total"] == 2 and set(data["cameras"]) == {"0", "1"}
    # the reference envelope the dashboard reads: status[id].state == "ok"
    assert data["status"]["0"] == {"state": "ok", "name": "Cam A", "geo": [18.5, 73.8]}
    assert data["active"] == [0, 1] and "rss_mb" in data["memory"]


def test_camera_crud(app):
    status, data, _ = app.call("POST", "/camera/add",
                               json_body={"id": 7, "name": "New", "source": "synthetic:32x32"})
    assert status == 201
    assert app.call("GET", "/camera/7/info")[1]["name"] == "New"
    status, data, _ = app.call("PATCH", "/camera/7", json_body={"name": "Renamed"})
    assert data["camera"]["name"] == "Renamed"
    assert app.error("POST", "/camera/add", json_body={"id": 7}) == 409
    assert app.call("DELETE", "/camera/7")[1]["deleted"] == 7
    assert app.error("GET", "/camera/7/info") == 404


def test_unknown_camera_404_and_bad_id_422(app):
    assert app.error("GET", "/camera/99/info") == 404
    assert app.error("GET", "/camera/99/snapshot") == 404
    assert app.error("POST", "/camera/99/restart") == 404
    assert app.error("GET", "/camera/abc/info") == 422
    assert app.error("POST", "/camera/add", json_body={"name": "no id"}) == 422


def test_camera_snapshot_and_feed(app):
    status, body, resp = app.call("GET", "/camera/0/snapshot")
    assert status == 200 and resp.content_type == "image/jpeg" and len(body) > 100
    _, _, resp = app.call("GET", "/camera/0/snapshot")
    assert resp.headers.get("X-Cache") == "hit"
    status, body, resp = app.call("GET", "/camera/0/feed", query={"fps": "30"})
    assert b"--frame" in body and b"image/jpeg" in body


def test_camera_scan_generates_alerts_and_tracking(app):
    emb = app.ctx.engine.encode_image(np.full((64, 64, 3), 77, np.uint8))[0]["embedding"]
    app.ctx.face_service.store_face("anyone", emb)
    # every face matches at this threshold
    status, data, _ = app.call("GET", "/camera/alerts", query={"threshold": "100"})
    assert status == 200
    assert data["metadata"]["cameras_scanned"] == 2
    assert [d["camera_id"] for d in data["detections"]] == [0, 1]
    assert {d["target"] for d in data["detections"]} == {"anyone"}
    assert app.ctx.tracking.stats["total_detections"] == 2
    assert [a["target"] for a in data["alerts"]] == ["anyone"]
    assert len(data["new_alerts"]) == 2 and data["movement_log"][0]["target"] == "anyone"
    # the tracker stores its records on a one-thread pool: wait for it
    app.ctx.tracking._persist_pool.submit(lambda: None).result()
    assert app.ctx.db["tracking"].count_documents({}) == 2


def test_camera_performance_and_test_endpoint(app):
    app.call("GET", "/camera/alerts", query={"threshold": "0.1"})
    status, data, _ = app.call("GET", "/camera/performance")
    assert "per_camera" in data and set(data["per_camera"]) == {"0", "1"}
    status, data, _ = app.call("POST", "/camera/test", json_body={"source": "synthetic:16x16"})
    assert data["success"] and data["frame_shape"] == [16, 16, 3]


def test_camera_health_probe(app):
    status, data, _ = app.call("GET", "/camera/health")
    assert data["cameras_total"] == 2 and data["cameras_healthy"] == 2


def test_camera_ingest_push_flow(app):
    body, ctype = _multipart({"camera_id": "9"}, {"file": ("f.jpg", _jpeg_bytes(140), "image/jpeg")})
    status, data, _ = app.call("POST", "/api/camera/ingest", body=body,
                               headers={"content-type": ctype})
    assert data["success"] and data["frames_pushed"] == 1
    ok, frame = app.ctx.cameras.get(9).read()
    assert ok and frame.shape == (64, 64, 3)
    status, _, resp = app.call("GET", "/camera/9/snapshot")
    assert status == 200 and resp.content_type == "image/jpeg"
    body, ctype = _multipart({"camera_id": "0"}, {"file": ("f.jpg", _jpeg_bytes(140), "image/jpeg")})
    assert app.error("POST", "/api/camera/ingest", body=body, headers={"content-type": ctype}) == 409


# --- face routes ----------------------------------------------------------------------

def test_face_upload_and_lifecycle(app):
    status, data, _ = _upload(app, "alice")
    assert status == 200 and data["success"] and data["target"] == "alice"
    assert app.error("POST", "/face/upload", **_upload_args("alice", 129)) == 409
    status, data, _ = _upload(app, "alice", value=130, override="true")
    assert data["success"] and data["overridden"]
    status, data, _ = app.call("GET", "/face/list")
    assert data["count"] == 1 and data["faces"][0]["target"] == "alice"
    assert app.call("GET", "/face/detail/alice")[1]["target"] == "alice"
    assert app.call("GET", "/face/search", query={"q": "ali"})[1]["matches"] == ["alice"]
    status, data, _ = app.call("PATCH", "/face/update/alice", json_body={"new_name": "alicia"})
    assert data["new"] == "alicia"
    assert app.call("DELETE", "/face/delete/alicia")[1]["success"]
    assert app.error("DELETE", "/face/delete/alicia") == 404


def test_face_delete_then_reenrol(app):
    _upload(app, "bob", value=90)
    first = app.ctx.face_service.gallery.get("bob")
    assert app.call("DELETE", "/face/delete/bob")[1]["removed_from_db"]
    assert "bob" not in app.ctx.face_service.get_all_targets()
    assert app.ctx.db["faces"].find_one({"target": "bob"}) is None
    # no 409 after the delete: the name is free again
    status, data, _ = _upload(app, "bob", value=91)
    assert status == 200 and not data["overridden"]
    again = app.ctx.face_service.gallery.get("bob")
    assert again is not None and not np.array_equal(first, again)
    assert app.ctx.db["faces"].find_one({"target": "bob"})["embedding"]


def test_face_upload_missing_target_422_and_oversize_413(app):
    body, ctype = _multipart({}, {"file": (".jpg", _jpeg_bytes(), "image/jpeg")})
    assert app.error("POST", "/face/upload", body=body, headers={"content-type": ctype}) == 422
    body, ctype = _multipart({"target": "x"}, {})
    assert app.error("POST", "/face/upload", body=body, headers={"content-type": ctype}) == 422
    big = b"\xff\xd8" + bytes(app.ctx.cfg.upload_max_mb * 1024 * 1024)
    assert app.error("POST", "/face/upload", **_upload_args("big", data=big)) == 413
    assert app.ctx.face_service.get_all_targets() == []


def test_face_upload_rejects_black_image_no_face(app):
    with pytest.raises(app.http.HTTPError) as e:
        _upload(app, "ghost", value=0)
    assert e.value.status == 400 and "no face" in e.value.detail


def test_face_compare_and_validate(app):
    _upload(app, "bob", value=90)
    body, ctype = _multipart({"tolerance": "2.0"}, {"file": ("q.jpg", _jpeg_bytes(90), "image/jpeg")})
    status, data, _ = app.call("POST", "/face/compare", body=body, headers={"content-type": ctype})
    assert data["success"] and data["results"][0]["best_match"]["target"] == "bob"
    body, ctype = _multipart({}, {"file": ("q.jpg", _jpeg_bytes(90), "image/jpeg")})
    status, data, _ = app.call("POST", "/face/validate", body=body, headers={"content-type": ctype})
    assert data["face_count"] == 1


def test_face_export_csv_and_clear(app):
    _upload(app, "carol")
    status, body, _ = app.call("GET", "/face/export", query={"format": "csv"})
    assert body.startswith(b"target,") and b"carol" in body
    assert app.error("DELETE", "/face/clear") == 400
    status, data, _ = app.call("DELETE", "/face/clear", query={"confirm": "CONFIRM_DELETE_ALL"})
    assert data["deleted"] == 1


def test_face_bulk_delete_cap(app):
    assert app.error("POST", "/face/delete/bulk",
                     json_body={"targets": [f"t{i}" for i in range(51)]}) == 422


# --- alerts, debug, router --------------------------------------------------------------

def test_alerts_routes(app):
    app.call("POST", "/alerts/watchlist", json_body={"target": "wanted"})
    assert app.call("GET", "/alerts/watchlist")[1]["watchlist"] == ["wanted"]
    app.call("POST", "/alerts/geofences", json_body={"name": "zone1", "cameras": [0]})
    app.ctx.alerts.generate_alert("wanted", 0, 0.3)
    status, data, _ = app.call("GET", "/alerts/", query={"priority": "critical"})
    assert data["total"] == 1
    alert_id = data["alerts"][0]["alert_id"]
    status, data, _ = app.call("POST", "/alerts/acknowledge",
                               json_body={"alert_id": alert_id, "acknowledged_by": "op"})
    assert data["success"]
    assert app.call("GET", "/alerts/latest")[1]["alert"]["acknowledged"]
    status, body, _ = app.call("GET", "/alerts/export", query={"format": "csv"})
    assert b"wanted" in body
    assert app.call("DELETE", "/alerts/watchlist/wanted")[1]["success"]
    assert app.call("POST", "/alerts/config/email", json_body={"enabled": False})[1]["success"]


def test_debug_routes(app):
    assert "stages" in app.call("GET", "/debug/timers")[1]
    assert "rss_mb" in app.call("GET", "/debug/memory")[1]
    with app.ctx.timers.track("unit"):
        pass
    assert app.call("GET", "/debug/timers")[1]["stages"]["unit"]["calls"] == 1
    data = app.call("GET", "/debug/delta")[1]
    assert {"keyframes", "deltas", "desyncs"} <= set(data)


def test_router_errors(app):
    assert app.router.resolve("GET", "/does/not/exist")[0] is None
    with pytest.raises(app.http.HTTPError) as e:
        app.router.resolve("DELETE", "/face/list")
    assert e.value.status == 405


# --- the port alone -------------------------------------------------------------------

def test_port_mounts_only_the_ported_routes(tmp_path):
    """Every route is ported: the port's build_app mounts every (method,
    pattern) of the JAX build_app, in the same order, and no other."""
    tables, routers = [], []
    for kind in ("jax", "torch"):
        a = App(kind, tmp_path / kind)
        a.ctx.shutdown()
        tables.append([(m, regex.pattern) for m, regex, _, _ in a.router._routes])
        routers.append(a.router)
    assert len(tables[1]) == len(set(tables[1])) > 100
    assert tables[1] == tables[0]
    for method, path in (("GET", "/face/fl/status"), ("GET", "/deepfake/config"),
                         ("GET", "/async/jobs/x"), ("GET", "/dashboard"),
                         ("GET", "/api/camera/0/snapshot"), ("GET", "/app/src/api.js")):
        assert routers[1].resolve(method, path)[0] is not None, path


def test_debug_trace_writes_a_chrome_trace(tmp_path):
    a = App("torch", tmp_path)
    try:
        started = a.call("POST", "/debug/trace/start", query={"label": "unit"})[1]
        assert started["success"]
        assert not a.call("POST", "/debug/trace/start")[1]["success"]
        a.call("GET", "/camera/alerts", query={"threshold": "0.1"})
        stopped = a.call("POST", "/debug/trace/stop")[1]
        assert stopped["success"] and stopped["trace_dir"] == started["trace_dir"]
        with open(os.path.join(stopped["trace_dir"], "trace.json")) as f:
            assert json.load(f)["traceEvents"]
        assert not a.call("POST", "/debug/trace/stop")[1]["success"]
    finally:
        a.ctx.shutdown()


def test_entry_points_mean_the_card(tmp_path, monkeypatch):
    """Without CUDA, the default device raises before anything is served;
    device="cpu" builds."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TContext(camera_configs=[])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(["--no-warmup", "--port", "0"])
    assert not os.path.exists(tmp_path / "store")


class _FailingWarmup(FakeEngine):
    def warmup(self, batch, h=None, w=None):
        raise RuntimeError("nvcc failed")


def test_failed_warmup_raises(tmp_path):
    cfg = load_config(data_dir=str(tmp_path / "data"), log_dir=str(tmp_path / "logs"))
    eng = _FailingWarmup()
    eng.gallery = TGallery(embed_dim=128)
    ctx = TContext(cfg=cfg, engine=eng, camera_configs=CAMS)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        asyncio.run(tmain.serve("127.0.0.1", 0, ctx=ctx))
    assert not ctx.health._thread or not ctx.health._thread.is_alive()


# --- the port's server on a live socket ------------------------------------------------

@pytest.fixture()
def live(tmp_path):
    """The port's HTTPServer on 127.0.0.1:0 in an event loop thread of its
    own; yields (port, ctx)."""
    cfg = load_config(data_dir=str(tmp_path / "data"), log_dir=str(tmp_path / "logs"),
                      min_face_quality=0.0)
    ctx = TContext(cfg=cfg, engine=_port_fake(), camera_configs=CAMS[:1])
    router, sio, ctx = tmain.build_app(ctx)
    server = thttp.HTTPServer(router, ws_handler=sio.handle_upgrade)
    loop = asyncio.new_event_loop()
    started = threading.Event()
    port = {}

    def run():
        asyncio.set_event_loop(loop)

        async def boot():
            s = await server.start("127.0.0.1", 0)
            port["port"] = s.sockets[0].getsockname()[1]
            started.set()

        loop.run_until_complete(boot())
        loop.run_forever()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert started.wait(10)
    yield port["port"], ctx
    asyncio.run_coroutine_threadsafe(server.stop(), loop).result(10)
    loop.call_soon_threadsafe(loop.stop)
    t.join(10)
    assert not t.is_alive()
    ctx.shutdown()


async def _http(port, method, path, headers=None, body=b""):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    headers = {"Host": "localhost", **(headers or {})}
    if body:
        headers["Content-Length"] = str(len(body))
    head = f"{method} {path} HTTP/1.1\r\n" + "".join(f"{k}: {v}\r\n" for k, v in headers.items())
    writer.write(head.encode() + b"\r\n" + body)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    resp_headers = {}
    while (line := await reader.readline()) not in (b"\r\n", b"\n", b""):
        k, v = line.decode().split(":", 1)
        resp_headers[k.strip().lower()] = v.strip()
    length = int(resp_headers.get("content-length", 0))
    data = await reader.readexactly(length) if length else b""
    writer.close()
    return status, resp_headers, data


def _client_frame(data: bytes) -> bytes:
    mask = os.urandom(4)
    assert len(data) < 126
    return bytes([0x81, 0x80 | len(data)]) + mask + bytes(
        b ^ mask[i % 4] for i, b in enumerate(data))


def test_live_server_http_upload_and_socketio_alert(live):
    port, ctx = live

    async def go():
        status, headers, body = await _http(port, "GET", "/")
        assert status == 200 and headers["access-control-allow-origin"] == "*"
        assert json.loads(body)["device"] == "" and json.loads(body)["status"] == "running"

        body, ctype = _multipart({"target": "live_person"},
                                 {"file": ("p.jpg", _jpeg_bytes(200), "image/jpeg")})
        status, _, resp = await _http(port, "POST", "/face/upload",
                                      headers={"Content-Type": ctype}, body=body)
        assert status == 200, resp
        assert json.loads(resp)["target"] == "live_person"
        assert ctx.face_service.get_all_targets() == ["live_person"]

        # Socket.IO over the WebSocket transport: handshake, connect, then a
        # scan that matches the enrolled face pushes 42["new_alert", ...]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        key = base64.b64encode(os.urandom(16)).decode()
        writer.write((
            "GET /socket.io/?EIO=4&transport=websocket HTTP/1.1\r\n"
            "Host: localhost\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n").encode())
        await writer.drain()
        assert b"101" in await reader.readline()
        while (await reader.readline()) not in (b"\r\n", b""):
            pass
        _, payload = await asyncio.wait_for(read_frame(reader), 5)
        assert payload.decode().startswith("0") and json.loads(payload.decode()[1:])["sid"]
        writer.write(_client_frame(b"40"))
        await writer.drain()
        _, payload = await asyncio.wait_for(read_frame(reader), 5)
        assert payload.decode().startswith("40")

        status, _, resp = await _http(port, "GET", "/camera/alerts?threshold=100")
        assert status == 200 and json.loads(resp)["new_alerts"]
        while True:
            _, payload = await asyncio.wait_for(read_frame(reader), 5)
            text = payload.decode()
            if text.startswith("42"):
                event, data = json.loads(text[2:])
                if event == "new_alert":
                    break
        assert data["target"] == "live_person" and data["camera_id"] == 0
        writer.close()

    asyncio.run(go())


def test_module_entry_point_serves_on_the_cpu(tmp_path):
    """python -m frp_tpu_torch.api.main --device cpu --port 0 --no-warmup
    builds the default engine on the CPU, prints where it listens and
    answers; the process is stopped after."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "frp_tpu_torch.api.main", "--device", "cpu", "--port", "0",
         "--host", "127.0.0.1", "--no-warmup"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        line = ""
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line or line.startswith("serving on"):
                break
        assert line.startswith("serving on http://127.0.0.1:"), line
        port = int(line.rsplit(":", 1)[1])
        status, _, body = asyncio.run(_http(port, "GET", "/"))
        data = json.loads(body)
        assert status == 200 and data["device"] == "cpu" and data["cameras"] == 5
        status, _, body = asyncio.run(_http(port, "GET", "/camera/status"))
        assert status == 200 and json.loads(body)["total"] == 5
    finally:
        proc.terminate()
        proc.wait(30)
    assert os.path.isdir(tmp_path / "data")
