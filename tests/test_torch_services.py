"""PyTorch port, the rest of the serving platform, on the CPU against the JAX
package:

- the route contract of tests/test_api.py and tests/test_frontend_contract.py
  for the federated, deepfake, async-task, snapshot, dashboard and frontend
  routes, each case run on the JAX app and on the port's app with the same
  fake engine (tests/test_torch_api.py's ``App``); the full deepfake and FL
  route sequences answer alike on both apps;
- tests/test_video_paths.py's cases on the port's ``DeepfakeService`` and
  ``VideoFileSource``;
- one MJPG clip through both packages' ``DeepfakeService`` on real CPU
  engines (JAX at seed 0, the port at f32): the same sampled indices, per
  frame the same face count and fake_prob within 1e-3, the same verdict,
  and statistics within one step of their 4 rounded decimals; a no-face
  frame gives fake_prob None in both;
- ``FederatedService`` and the FedAvg host math on both packages: the JAX
  service's cases, the combine bit for bit in float64, a weights directory
  written by either package warm-loading in the other;
- ``enhance_snapshot_bytes`` bit for bit on the same JPEG (Pillow and cv2);
- an async face search on both apps with the real engines: the same match;
- a deepfake video processed while a scan stream runs on the same engine in
  another thread: the same result as alone, and no delta desync.
"""

import asyncio
import json
import os
import re
import sys
import threading
import time
import zlib

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from frp_tpu.api import http as jhttp
from frp_tpu.api.main import build_app as j_build_app
from frp_tpu.config import load_config as j_load_config
from frp_tpu.engine.pipeline import RecognitionEngine as JEngine
from frp_tpu.ops import fedavg as jfedavg
from frp_tpu.platform import enhancer as jenhancer
from frp_tpu.platform.context import AppContext as JContext
from frp_tpu.platform.deepfake import DeepfakeService as JDeepfake
from frp_tpu.platform.federated import FederatedService as JFederated
from frp_tpu.train.synthetic import make_scene

import frp_tpu_torch.engine.batching as tbatch
from frp_tpu_torch.api import http as thttp
from frp_tpu_torch.api.main import build_app as t_build_app
from frp_tpu_torch.api.routes import dashboard as tdashboard
from frp_tpu_torch.api.routes import frontend as tfrontend
from frp_tpu_torch.config import load_config
from frp_tpu_torch.engine.pipeline import RecognitionEngine
from frp_tpu_torch.ops import fedavg as tfedavg
from frp_tpu_torch.platform import enhancer as tenhancer
from frp_tpu_torch.platform.context import AppContext as TContext
from frp_tpu_torch.platform.deepfake import DeepfakeService as TDeepfake
from frp_tpu_torch.platform.federated import FederatedService as TFederated
from frp_tpu_torch.platform.state import CameraRegistry, VideoFileSource
from frp_tpu_torch.testing.synthetic import write_face_clip
from tests.test_frontend import client_endpoints
from tests.test_torch_api import App, _jpeg_bytes, _multipart, _port_fake, _upload

DET = 128
KW = dict(det_size=DET, max_faces_per_frame=4, pre_nms_topk=64,
          det_conf_threshold=0.3, compute_dtype="float32")
PKGS = {"jax": (JDeepfake, JFederated, jfedavg), "torch": (TDeepfake, TFederated, tfedavg)}
# fields that hold a time, a duration, a random id or a path of the run
VOLATILE = {"timestamp", "processing_time", "saved_at", "registered_at", "last_upload", "last_update",
            "created_at", "started_at", "finished_at", "job_id", "exported_at",
            "weights_dir", "total_processing_time", "average_processing_time"}


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs its files in parallel worker processes: two intra-op
    threads a test keep those from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["jax", "torch"])
def app(request, tmp_path):
    a = App(request.param, tmp_path)
    yield a
    a.ctx.shutdown()


def _strip(obj):
    """obj without VOLATILE fields, at any depth."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _wait_job(app, job_id, timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline:
        job = app.call("GET", f"/async/jobs/{job_id}")[1]
        if job["status"] in ("finished", "failed"):
            return job
        time.sleep(0.05)
    raise AssertionError(f"job {job_id} did not finish in {timeout} s")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 256x144 MJPG clip of 12 frames: one moving face, gone from frames 8
    and 9."""
    path = str(tmp_path_factory.mktemp("clips") / "walk.avi")
    has_face = write_face_clip(path, 256, 144, 12, seed=3, size=100)
    assert has_face == [True] * 8 + [False] * 2 + [True] * 2
    return path


def _video_form(path, name="walk.avi", **fields):
    with open(path, "rb") as f:
        body, ctype = _multipart(fields, {"file": (name, f.read(), "video/x-msvideo")})
    return dict(body=body, headers={"content-type": ctype})


# --- (a) the route contract on both apps --------------------------------------------

def test_fl_roundtrip(app):
    for cid, val in (("c1", [1.0, 2.0]), ("c2", [3.0, 4.0])):
        data = app.call("POST", "/face/fl/upload_weights",
                        json_body={"client_id": cid, "weights": {"w": val}})[1]
        assert data["success"]
    data = app.call("POST", "/face/fl/aggregate", json_body={})[1]
    assert data["success"] and data["version"] == 1
    assert app.call("GET", "/face/fl/global_model")[1]["weights"]["w"] == [2.0, 3.0]
    assert app.call("GET", "/face/fl/status")[1]["version"] == 1
    assert len(app.call("GET", "/face/fl/history")[1]["history"]) == 1
    assert app.error("POST", "/face/fl/upload_weights",
                     json_body={"client_id": "bad", "weights": {"w": [None]}}) == 400
    assert app.error("POST", "/face/fl/reset", json_body={}) == 400
    assert app.call("POST", "/face/fl/reset", json_body={"confirm": "CONFIRM_RESET"})[1]["success"]


def test_fl_validate_and_rounds(app):
    assert app.call("POST", "/face/fl/validate", json_body={"weights": {"w": [1.0]}})[1]["valid"]
    assert app.call("POST", "/face/fl/round/start")[1]["status"] == "collecting"
    assert app.call("GET", "/face/fl/round/status")[1]["round"] >= 1


def test_fl_upload_envelope(app):
    data = app.call("POST", "/face/fl/upload_weights",
                    json_body={"target": "client_1",
                               "weights": {"layer1": [0.1, 0.2], "layer2": [0.3, 0.4]}})[1]
    assert data["status"] == "success"
    for key in ("message", "client_id", "round", "layers", "total_parameters",
                "contribution_count", "global_model_version", "timestamp"):
        assert key in data, key


def test_fl_get_weights_envelope(app):
    app.call("POST", "/face/fl/upload_weights",
             json_body={"target": "client_1", "weights": {"layer1": [0.1, 0.2]}})
    data = app.call("GET", "/face/fl/get_weights", query={"target": "client_1"})[1]
    assert data["status"] == "success" and data["weights"] == {"layer1": [0.1, 0.2]}
    status, data, _ = app.call("GET", "/face/fl/get_weights", query={"target": "nobody"})
    assert status == 200 and data["status"] == "success" and data["weights"] == {}


def test_fl_aggregate_envelope(app):
    for c in ("a", "b"):
        app.call("POST", "/face/fl/upload_weights",
                 json_body={"target": c, "weights": {"layer1": [1.0, 2.0]}})
    data = app.call("POST", "/face/fl/aggregate", json_body={})[1]
    assert data["status"] == "success"
    assert data["message"] == "Model aggregation completed successfully"
    assert data["new_model_version"] == data["global_model"]["version"] == 1
    assert data["global_model"]["layers"] == ["layer1"]
    assert data["global_model"]["total_parameters"] == 2
    det = data["aggregation_details"]
    assert det["clients_aggregated"] == 2 and set(det["client_ids"]) == {"a", "b"}
    assert det["weights_strategy"] == "equal" and data["backend"] == "host"


def test_deepfake_info_endpoints(app):
    data = app.call("GET", "/deepfake/model/info")[1]
    assert data["fake_index"] == 1 and data["weights_loaded"] is False
    assert app.call("GET", "/deepfake/config")[1]["max_frames"] == 20
    assert app.call("GET", "/deepfake/stats")[1]["total_videos"] == 0
    assert app.call("GET", "/deepfake/health")[1]["status"] == "healthy"


def test_deepfake_detect_image(app):
    body, ctype = _multipart({}, {"file": ("f.jpg", _jpeg_bytes(77), "image/jpeg")})
    data = app.call("POST", "/deepfake/detect-image", body=body,
                    headers={"content-type": ctype})[1]
    assert data["result"] in ("real", "fake") and data["faces"] == 1


def test_deepfake_detect_video_cached_and_validate(app, clip):
    status, data, _ = app.call("POST", "/deepfake/detect", **_video_form(clip))
    assert status == 200 and data["cached"] is False
    assert data["frames_sampled"] == 12 and data["frames_with_faces"] == 12  # FakeEngine
    assert data["result"] == "real" and data["video_info"]["width"] == 256
    assert app.call("POST", "/deepfake/detect", **_video_form(clip))[1]["cached"] is True
    data = app.call("POST", "/deepfake/validate", **_video_form(clip))[1]
    assert data["valid"] and data["video_info"]["frame_count"] == 12
    body, ctype = _multipart({}, {"file": ("notes.txt", b"hello", "text/plain")})
    assert app.error("POST", "/deepfake/detect", body=body, headers={"content-type": ctype}) == 400
    # the uploads were removed after each request
    assert os.listdir(app.ctx.cfg.deepfake_uploads_path()) == []


def test_async_search_route(app):
    _upload(app, "dave", value=60)
    body, ctype = _multipart({"tolerance": "2.0"}, {"file": ("q.jpg", _jpeg_bytes(60), "image/jpeg")})
    status, data, _ = app.call("POST", "/async/face/search", body=body,
                               headers={"content-type": ctype})
    assert status == 202
    job = _wait_job(app, data["job_id"])
    assert job["status"] == "finished"
    assert job["result"]["results"][0]["best_match"]["target"] == "dave"
    jobs = app.call("GET", "/async/jobs", query={"status": "finished"})[1]
    assert [j["job_id"] for j in jobs["jobs"]] == [data["job_id"]]
    assert jobs["stats"]["by_status"] == {"finished": 1}
    assert app.error("GET", "/async/jobs/nope") == 404


def test_async_job_envelope(app):
    body, ctype = _multipart({}, {"file": ("q.jpg", _jpeg_bytes(), "image/jpeg")})
    status, data, _ = app.call("POST", "/async/face/search", body=body,
                               headers={"content-type": ctype})
    assert status == 202 and data["job_id"]
    job = _wait_job(app, data["job_id"])
    assert job["status"] == "finished" and "result" in job


def test_snapshot_route_placeholder_and_etag(app):
    status, data, resp = app.call("GET", "/api/camera/0/snapshot")
    assert status == 200 and resp.content_type == "image/jpeg"
    status, _, resp2 = app.call("GET", "/api/camera/0/snapshot",
                                headers={"if-none-match": resp.headers["ETag"]})
    assert status == 304 and resp2.headers["ETag"] == resp.headers["ETag"]
    status, body, resp = app.call("GET", "/api/camera/99/snapshot")
    assert status == 404 and resp.content_type == "image/svg+xml"
    assert app.error("GET", "/api/camera/abc/snapshot") == 422


def test_snapshot_headers(app):
    status, _, resp = app.call("GET", "/api/camera/0/snapshot", query={"enhance": "true"})
    assert status == 200 and resp.headers.get("X-Enhance-Requested") == "1"
    status, _, resp = app.call("GET", "/api/camera/99/snapshot")
    assert status == 404 and resp.headers.get("X-Placeholder") == "1"


def test_snapshot_enhance_replaces_the_cached_bytes(app):
    """?enhance=1 answers with the cached JPEG at once and, in the
    background, caches enhance_snapshot_bytes of it with the config's
    knobs."""
    enhancer = jenhancer if app.http is jhttp else tenhancer
    handler, params = app.router.resolve("GET", "/api/camera/0/snapshot")

    async def go():
        resp = await handler(app.http.Request("GET", "/api/camera/0/snapshot", {"enhance": "1"},
                                              {}, b"", params))
        for task in asyncio.all_tasks() - {asyncio.current_task()}:
            await task
        return resp

    resp = asyncio.run(go())
    cfg = app.ctx.cfg
    want = enhancer.enhance_snapshot_bytes(
        resp.body, upscale=cfg.enhancer_upscale, max_pixels=cfg.enhancer_max_pixels,
        sharpen=cfg.enhancer_sharpen, quality=cfg.enhancer_jpeg_quality)
    assert resp.status == 200 and want and want != resp.body
    assert app.ctx.thumbnails.get("cam:0") == want


def test_blanket_status_success_envelope(app):
    for path in ("/deepfake/history", "/deepfake/stats", "/face/fl/stats", "/face/fl/global_model"):
        status, data, _ = app.call("GET", path)
        assert status == 200 and isinstance(data, dict) and "status" in data, path


def test_dashboard_served(app):
    status, body, resp = app.call("GET", "/dashboard")
    assert status == 200 and resp.content_type.startswith("text/html")
    assert b"face-recognition-platform" in body and b"new_alert" in body


def test_app_serves_the_repo_frontend(app):
    status, body, resp = app.call("GET", "/app")
    assert status == 200 and resp.content_type.startswith("text/html")
    with open(os.path.join(tfrontend.frontend_dir(), "index.html"), "rb") as f:
        assert body == f.read()
    status, body, resp = app.call("GET", "/app/src/api.js")
    assert status == 200 and resp.content_type.startswith("text/javascript")
    assert app.call("GET", "/app/app.css")[2].content_type.startswith("text/css")
    assert app.call("GET", "/app/missing.js")[0] == 404
    for path in ("/app/src/..", "/app/..", "/app/src/..%2f..%2fREADME.md"):
        if app.router.resolve("GET", path)[0] is not None:
            assert app.call("GET", path)[0] == 404, path


def test_client_endpoints_resolve(app):
    """Every URL the shipped client (frontend/src/api.js) calls resolves."""
    for method, raw in client_endpoints():
        path = re.sub(r"\$\{[^}]*\}", "testvalue", raw).split("?")[0] or "/"
        assert app.router.resolve(method, path)[0] is not None, (method, raw)


# --- both apps, the same answers ---------------------------------------------------

def _both(tmp_path):
    return App("jax", tmp_path / "j"), App("torch", tmp_path / "t")


def test_deepfake_routes_answer_alike(tmp_path, clip):
    apps = _both(tmp_path)
    img = _multipart({"threshold": "0.1"}, {"file": ("f.jpg", _jpeg_bytes(90), "image/jpeg")})
    try:
        got = []
        for a in apps:
            seq = [a.call("POST", "/deepfake/detect", **_video_form(clip, random_sampling="true")),
                   a.call("POST", "/deepfake/detect", **_video_form(clip)),
                   a.call("POST", "/deepfake/detect-image", body=img[0],
                          headers={"content-type": img[1]}),
                   a.call("GET", "/deepfake/cctv", query={"max_frames": "2"}),
                   a.call("GET", "/deepfake/history", query={"limit": "5"}),
                   a.call("GET", "/deepfake/stats"),
                   a.call("GET", "/deepfake/export", query={"format": "csv"}),
                   a.call("GET", "/deepfake/cache/info"),
                   a.call("GET", "/deepfake/formats"),
                   a.call("GET", "/deepfake/config"),
                   a.call("DELETE", "/deepfake/cache"),
                   a.call("POST", "/deepfake/cache/clear"),
                   a.call("DELETE", "/deepfake/history"),
                   a.call("POST", "/deepfake/stats/reset")]
            got.append([(s, _strip(d) if isinstance(d, dict) else d.count(b"\n"))
                        for s, d, _ in seq])
            assert a.call("GET", "/deepfake/stats")[1]["total_videos"] == 0
        assert got[0] == got[1]
        assert got[1][3][1]["cameras"] == {"0": {"frames": 2, "real": 2, "fake": 0, "no_faces": 0},
                                          "1": {"frames": 2, "real": 2, "fake": 0, "no_faces": 0}}
        info = [a.call("GET", "/deepfake/model/info")[1] for a in apps]
        assert info[0].pop("architecture") == "MobileNetV3-Small (JAX, NHWC/bf16)"
        assert info[1].pop("architecture") == "MobileNetV3-Small (PyTorch, NHWC/bf16)"
        assert info[0] == info[1]
        # the store document and the bounded event log
        for a in apps:
            # the second detect was served from the cache (the key is the
            # content, whatever the sampling)
            assert [d["result"] for d in a.ctx.db["deepfakes"].find({})] == ["real"]
            with open(os.path.join(a.ctx.cfg.deepfake_logs_path(), "deepfake_events.json")) as f:
                assert [e["result"] for e in json.load(f)] == ["real"]
    finally:
        for a in apps:
            a.ctx.shutdown()


def test_fl_routes_answer_alike(tmp_path):
    apps = _both(tmp_path)
    rng = np.random.default_rng(0)
    ups = [{"client_id": f"c{i}", "weights": {"w": rng.normal(size=(3, 2)).tolist(),
                                              "b": rng.normal(size=2).tolist()}}
           for i in range(3)]
    try:
        got = []
        for a in apps:
            seq = [a.call("POST", "/face/fl/register",
                          json_body={"client_id": "c0", "client_name": "zero"})]
            seq += [a.call("POST", "/face/fl/upload_weights", json_body=u) for u in ups]
            seq += [a.call("POST", "/face/fl/upload_weights", json_body=ups[0]),
                    a.call("POST", "/face/fl/aggregate",
                           json_body={"weights_strategy": "contribution"}),
                    a.call("POST", "/face/fl/aggregate",
                           json_body={"client_ids": ["c1", "c2"], "min_clients": 2}),
                    a.call("GET", "/face/fl/global_model", query={"version": "1"}),
                    a.call("GET", "/face/fl/global_model"),
                    a.call("GET", "/face/fl/status", query={"client_id": "c1"}),
                    a.call("GET", "/face/fl/list"),
                    a.call("GET", "/face/fl/aggregation/history"),
                    a.call("GET", "/face/fl/stats"),
                    a.call("GET", "/face/fl/client/c0/metrics"),
                    a.call("GET", "/face/fl/export", query={"format": "csv"}),
                    a.call("GET", "/face/fl/health"),
                    a.call("DELETE", "/face/fl/weights/c2"),
                    a.call("DELETE", "/face/fl/unregister/c1"),
                    a.call("GET", "/face/fl/clients")]
            got.append([(s, _strip(d) if isinstance(d, dict) else d.count(b"\n"))
                        for s, d, _ in seq])
            assert a.error("POST", "/face/fl/aggregate", json_body={"client_ids": ["c9"]}) == 400
        assert got[0] == got[1]
        # c0 uploaded twice, c1 and c2 once
        assert got[1][5][1]["aggregation_details"]["aggregation_weights"] == {
            "c0": 0.5, "c1": 0.25, "c2": 0.25}
    finally:
        for a in apps:
            a.ctx.shutdown()


def test_port_dashboard_page_differs_only_in_its_label():
    from frp_tpu.api.routes import dashboard as jdashboard

    assert tdashboard.PAGE.replace("PyTorch", "TPU") == jdashboard.PAGE


def test_frontend_dir_is_the_repo_frontend():
    from frp_tpu.api.routes import frontend as jfrontend

    assert os.path.samefile(tfrontend.frontend_dir(), jfrontend.frontend_dir())
    assert os.path.isfile(os.path.join(tfrontend.frontend_dir(), "index.html"))
    assert tfrontend._SAFE_NAME.pattern == jfrontend._SAFE_NAME.pattern


# --- (b) tests/test_video_paths.py on the port ---------------------------------------

@pytest.fixture(scope="module")
def video_path(tmp_path_factory):
    """tests/test_video_paths.py's clip, rendered with the port's render_face."""
    from frp_tpu_torch.testing.synthetic import render_face

    path = str(tmp_path_factory.mktemp("vids") / "clip.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (160, 120))
    assert w.isOpened()
    rng = np.random.default_rng(0)
    for _ in range(30):
        rgb = rng.integers(20, 110, (120, 160, 3), dtype=np.uint8)
        render_face(rgb, 80.0, 60.0, 40.0, np.random.default_rng(1))
        w.write(np.ascontiguousarray(rgb[..., ::-1]))
    w.release()
    return path


def _service(**kw):
    return TDeepfake(_port_fake(), max_frames=8, **kw)


def test_probe_and_sampling(video_path):
    svc = _service()
    info = svc.probe_video(video_path)
    assert info["frame_count"] == 30 and info["width"] == 160
    idx = svc._sample_indices(30, random_sampling=False)
    assert len(idx) == 8 and idx[0] == 0 and idx[-1] < 30
    assert np.all(np.diff(idx) > 0)
    assert len(svc._sample_indices(5, False)) == 5


def test_process_video_labels_and_stats(video_path):
    svc = _service()
    result = svc.process_video(video_path)
    assert result["frames_sampled"] == 8 and result["frames_with_faces"] == 8
    assert result["result"] == "real" and result["confidence"] == "high"
    assert result["model_trained"] is False
    stats = svc.get_statistics()
    assert stats["total_videos"] == 1 and stats["real_detected"] == 1
    assert len(svc.get_history()) == 1


def test_process_video_cached_dedup(video_path):
    svc = _service()
    r1 = svc.process_video_cached(video_path)
    r2 = svc.process_video_cached(video_path)
    assert r1["cached"] is False and r2["cached"] is True
    assert svc.get_statistics()["total_videos"] == 1
    assert svc.clear_cache() == 1


def test_video_file_source_loops(video_path):
    src = VideoFileSource(video_path)
    assert src.opened
    for _ in range(35):
        ok, frame = src.read()
        assert ok and frame.shape == (120, 160, 3)
    assert src.restart()
    src.release()


def test_cctv_sweep_tallies(video_path):
    svc = _service()
    reg = CameraRegistry()
    reg.init_cameras([
        {"id": 0, "name": "A", "source": f"file:{video_path}"},
        {"id": 1, "name": "B", "source": "synthetic:64x48"},
    ])
    out = svc.sweep_cameras(reg.all(), max_frames_per_cam=2)
    assert set(out["cameras"]) == {0, 1}
    for tally in out["cameras"].values():
        assert tally["frames"] == 2
        assert tally["real"] + tally["fake"] + tally["no_faces"] == 2
    reg.close_all()


def test_event_log_bounded_and_tolerant_of_foreign_content(video_path, tmp_path):
    logs = str(tmp_path / "logs")
    svc = _service(logs_dir=logs)
    path = os.path.join(logs, "deepfake_events.json")
    os.makedirs(logs, exist_ok=True)
    with open(path, "w") as f:
        f.write('{"foreign": true}')
    svc.process_video(video_path)
    with open(path) as f:
        events = json.load(f)
    assert isinstance(events, list) and len(events) == 1
    cap = svc.history.maxlen
    with open(path, "w") as f:
        json.dump(events * (cap + 50), f)
    svc.process_video(video_path)
    with open(path) as f:
        assert len(json.load(f)) == cap


@pytest.mark.parametrize("weights_loaded", [True, False])
def test_deepfake_model_info_equals_jax(weights_loaded):
    """The measured eval artifact (weights/spoof_eval.json) is published as
    the JAX service does; only the architecture string names PyTorch."""
    j = JDeepfake(engine=None, weights_loaded=weights_loaded).model_info()
    t = TDeepfake(engine=None, weights_loaded=weights_loaded).model_info()
    assert j.pop("architecture") != t.pop("architecture")
    assert t == j
    assert ("evaluation" in t) == weights_loaded


# --- (c) one clip through both packages on real CPU engines ----------------------------

@pytest.fixture(scope="module")
def engines():
    torch.set_num_threads(2)
    return JEngine(j_load_config(**KW), seed=0), RecognitionEngine(load_config(**KW), device="cpu")


def test_sample_indices_equal():
    for frames in (1, 7, 8, 9, 30, 61, 1000):
        for rand in (False, True):
            for name in ("a.avi", "walk.mp4"):
                seed = zlib.crc32(f"{name}:{frames}".encode())
                j = JDeepfake(None, max_frames=8)._sample_indices(frames, rand, seed)
                t = TDeepfake(None, max_frames=8)._sample_indices(frames, rand, seed)
                assert np.array_equal(j, t), (frames, rand)


@pytest.mark.parametrize("random_sampling", [False, True])
def test_deepfake_video_on_real_engines_equals_jax(engines, clip, random_sampling):
    jeng, teng = engines
    res = []
    for cls, eng in zip((JDeepfake, TDeepfake), engines):
        svc = cls(eng, max_frames=8)
        info = svc.probe_video(clip)
        seed = zlib.crc32(f"{os.path.basename(clip)}:{info['frame_count']}".encode())
        idx = svc._sample_indices(info["frame_count"], random_sampling, seed)
        res.append((idx, svc.process_video(clip, random_sampling=random_sampling)))
    (jidx, j), (tidx, t) = res
    assert np.array_equal(jidx, tidx) and len(tidx) == 8
    for key in ("result", "confidence", "frames_sampled", "frames_with_faces",
                "threshold", "video_info", "model_trained"):
        assert j[key] == t[key], key
    # the service rounds the statistics to 4 decimals: one rounding step
    assert j["statistics"].keys() == t["statistics"].keys()
    for key, value in j["statistics"].items():
        assert abs(value - t["statistics"][key]) <= 1e-4 + 1e-9, key
    assert t["frames_with_faces"] >= 5 and t["result"] in ("real", "fake")
    assert len(j["frame_results"]) == len(t["frame_results"]) == 8
    no_face = 0
    for a, b in zip(j["frame_results"], t["frame_results"]):
        assert a["faces"] == b["faces"]
        if a["fake_prob"] is None:
            assert b["fake_prob"] is None and a["faces"] == 0 and "boxes" not in b
            no_face += 1
            continue
        assert abs(a["fake_prob"] - b["fake_prob"]) <= 1e-3
        assert np.abs(np.subtract(a["boxes"], b["boxes"])).max() <= 1e-2
    # frames 8 and 9 hold no face; the uniform draw takes frame 9
    assert no_face >= (1 if not random_sampling else 0)


# --- (d) federated learning on both packages ----------------------------------------------

@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_federated_upload_aggregate_roundtrip(pkg, tmp_path):
    svc = PKGS[pkg][1](weights_dir=str(tmp_path / "fl"), min_clients=2)
    svc.upload_weights("c1", {"w": [1.0, 2.0], "b": [0.0]})
    svc.upload_weights("c2", {"w": [3.0, 4.0], "b": [2.0]})
    out = svc.aggregate()
    assert out["success"] and out["version"] == 1 and out["backend"] == "host"
    name, model = svc.get_global_model()
    assert name == "global_model_v1"
    np.testing.assert_allclose(model["w"], [2.0, 3.0])
    np.testing.assert_allclose(model["b"], [1.0])
    assert svc.status()["round"] == 1


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_federated_min_clients_gate(pkg, tmp_path):
    svc = PKGS[pkg][1](weights_dir=str(tmp_path / "fl"), min_clients=2)
    svc.upload_weights("c1", {"w": [1.0]})
    with pytest.raises(PKGS[pkg][2].FedAvgError, match="at least 2"):
        svc.aggregate()
    assert svc.state["status"] == "idle"


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_federated_nan_reject_and_structure_warning(pkg, tmp_path):
    svc = PKGS[pkg][1](weights_dir=str(tmp_path / "fl"))
    with pytest.raises(PKGS[pkg][2].FedAvgError, match="NaN"):
        svc.upload_weights("c1", {"w": [float("nan")]})
    svc.upload_weights("c1", {"w": [1.0]})
    assert svc.upload_weights("c1", {"w": [1.0], "extra": [2.0]})["warning"] is not None


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_federated_disk_warm_load(pkg, tmp_path):
    d = str(tmp_path / "fl")
    svc = PKGS[pkg][1](weights_dir=d, min_clients=1)
    svc.upload_weights("c1", {"w": [5.0]})
    svc.aggregate(min_clients=1)
    svc2 = PKGS[pkg][1](weights_dir=d, min_clients=1)
    assert svc2.state["version"] == 1 and svc2.get_weights("c1") is not None
    np.testing.assert_allclose(svc2.get_global_model()[1]["w"], [5.0])


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_federated_proportional_weights(pkg, tmp_path):
    svc = PKGS[pkg][1](weights_dir=str(tmp_path / "fl"), min_clients=2)
    for _ in range(3):
        svc.upload_weights("c1", {"w": [4.0]})
    svc.upload_weights("c2", {"w": [0.0]})
    svc.aggregate(proportional=True)
    np.testing.assert_allclose(svc.get_global_model()[1]["w"], [3.0])


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_fl_upload_cannot_clobber_global_model(pkg, tmp_path):
    fl = PKGS[pkg][1](weights_dir=str(tmp_path), min_clients=2)
    for c in ("a", "b"):
        fl.upload_weights(c, {"l1": [1.0, 2.0]})
    fl.aggregate()
    before = fl.get_weights("global_model_v1")
    with pytest.raises(PKGS[pkg][2].FedAvgError):
        fl.upload_weights("global_model_v1", {"evil": [9.0]})
    assert set(fl.get_weights("global_model_v1")) == set(before) == {"l1"}


@pytest.mark.parametrize("proportional", [False, True])
def test_federated_combine_bit_equal(proportional, tmp_path):
    """Five clients of random layers, uneven contributions: the global models
    of both services are equal in float64, bit for bit."""
    rng = np.random.default_rng(7)
    ups = [{"conv": rng.normal(size=(3, 3, 4)), "fc": rng.normal(size=(10,)) * 1e3,
            "s": rng.normal(size=())} for _ in range(5)]
    models = []
    for pkg in ("jax", "torch"):
        svc = PKGS[pkg][1](weights_dir=str(tmp_path / pkg), min_clients=5)
        for i, u in enumerate(ups):
            for _ in range(i % 3 + 1):
                svc.upload_weights(f"c{i}", {k: v.tolist() for k, v in u.items()})
        out = svc.aggregate(proportional=proportional)
        models.append((out["weights"], svc.get_global_model()[1]))
    (jw, jm), (tw, tm) = models
    assert jw == tw and jm.keys() == tm.keys()
    for k in jm:
        assert jm[k].dtype == tm[k].dtype == np.float64 and np.array_equal(jm[k], tm[k]), k


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_federated_weights_dir_warm_loads_across_packages(direction, tmp_path):
    first, second = (JFederated, TFederated) if direction == "jax_to_port" else (TFederated, JFederated)
    d = str(tmp_path / "fl")
    svc = first(weights_dir=d, min_clients=2)
    rng = np.random.default_rng(3)
    for c in ("a", "b", "c"):
        svc.upload_weights(c, {"w": rng.normal(size=(2, 3)).tolist()})
    svc.aggregate()
    svc.aggregate(client_ids=["a", "b"])
    other = second(weights_dir=d, min_clients=2)
    assert other.status() == {**svc.status(), "active_clients": []}
    assert sorted(c["client_id"] for c in other.list_clients()) == ["a", "b", "c"]
    for name in svc.status()["stored_weight_sets"]:
        assert np.array_equal(other.get_weights(name)["w"], svc.get_weights(name)["w"]), name
    # the next round continues the version sequence
    other.upload_weights("a", {"w": np.zeros((2, 3)).tolist()})
    other.upload_weights("b", {"w": np.ones((2, 3)).tolist()})
    assert other.aggregate(client_ids=["a", "b"])["version"] == 3


def test_federated_takes_a_mesh(tmp_path):
    """The FL service's mesh branch (it raised NotImplementedError before
    the mesh was ported): over two positions, 3 clients padded to 4, the
    JAX service's mesh_psum result on its 2-device mesh within f32."""
    from frp_tpu.parallel.mesh import make_mesh as j_make_mesh

    from frp_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(5)
    updates = {c: {"w": rng.normal(size=(4, 3)), "b": rng.normal(size=3)} for c in "xyz"}
    svcs = [JFederated(weights_dir=str(tmp_path / "j"), mesh=j_make_mesh(n_data=2)),
            TFederated(weights_dir=str(tmp_path / "t"),
                       mesh=make_mesh(n_data=2, devices=["cpu", "cpu"]))]
    res = []
    for svc in svcs:
        for c, u in updates.items():
            svc.upload_weights(c, {k: v.tolist() for k, v in u.items()})
        res.append(svc.aggregate(client_ids=list("xyz"), proportional=True))
    assert res[0]["backend"] == res[1]["backend"] == "mesh_psum[2]"
    j, t = (svc.get_weights(r["global_model"]) for svc, r in zip(svcs, res))
    for k in ("w", "b"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-6, atol=1e-7)


def test_fedavg_host_math_equals_jax():
    rng = np.random.default_rng(1)
    updates = {c: {"w": rng.normal(size=(4, 3)), "b": rng.normal(size=3)} for c in "xyz"}
    for mod in (jfedavg, tfedavg):
        assert mod.check_layer_consistency(updates) == ["b", "w"]
    for contrib, prop in (({"x": 1, "y": 2, "z": 5}, True), ({"x": 0, "y": 0, "z": 0}, True),
                          (None, False), ({"x": -3, "y": 1, "z": 1}, True)):
        w = tfedavg.resolve_weights(list("xyz"), contrib, prop)
        assert w == jfedavg.resolve_weights(list("xyz"), contrib, prop)
        j, t = jfedavg.fedavg_combine(updates, w), tfedavg.fedavg_combine(updates, w)
        assert all(np.array_equal(j[k], t[k]) for k in j)
    for upd in ({"w": [[1.0, 2.0]], "s": 3}, {"w": []}, {}, {"w": [float("inf")]},
                {"w": "abc"}, {"w": [[1.0], [2.0, 3.0]]}, "not a dict"):
        got = []
        for mod in (jfedavg, tfedavg):
            try:
                got.append(mod.validate_client_update(upd))
            except ValueError as e:  # FedAvgError, or numpy's on a ragged list
                got.append((type(e).__name__, str(e)))
        assert got[0] == got[1], upd
    bad = {"x": {"w": np.zeros(2)}, "y": {"w": np.zeros(3)}}
    for mod in (jfedavg, tfedavg):
        with pytest.raises(mod.FedAvgError, match="shape mismatch"):
            mod.fedavg_combine(bad, {"x": 0.5, "y": 0.5})
        with pytest.raises(mod.FedAvgError, match="structure mismatch"):
            mod.check_layer_consistency({"x": {"w": 1}, "y": {"v": 1}})
        with pytest.raises(mod.FedAvgError, match="no client"):
            mod.check_layer_consistency({})


def test_fedavg_tree_equals_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    stacked = {"w": rng.normal(size=(5, 3, 4)).astype(np.float32),
               "b": rng.normal(size=(5,)).astype(np.float32)}
    weights = rng.random(5).astype(np.float32)
    weights /= weights.sum()
    j = jfedavg.fedavg_tree({k: jnp.asarray(v) for k, v in stacked.items()}, jnp.asarray(weights))
    t = tfedavg.fedavg_tree({k: torch.from_numpy(v) for k, v in stacked.items()},
                            torch.from_numpy(weights))
    for k in stacked:
        assert t[k].dtype == torch.float32 and tuple(t[k].shape) == stacked[k].shape[1:]
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=0, atol=1e-6)


# --- (e) the snapshot enhancer ----------------------------------------------------------

@pytest.mark.parametrize("branch", ["pil", "cv2"])
@pytest.mark.parametrize("kw", [{}, {"sharpen": False, "quality": 60}, {"upscale": 3.0, "max_pixels": 50_000}])
def test_enhance_snapshot_bytes_bit_equal(branch, kw, monkeypatch):
    img = make_scene(96, np.random.default_rng(5), max_faces=1, portrait=True)[0]
    data = cv2.imencode(".jpg", np.ascontiguousarray(img[..., ::-1]))[1].tobytes()
    if branch == "cv2":
        monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL raises ImportError
    j = jenhancer.enhance_snapshot_bytes(data, **kw)
    t = tenhancer.enhance_snapshot_bytes(data, **kw)
    assert j is not None and t == j
    out = cv2.imdecode(np.frombuffer(t, np.uint8), cv2.IMREAD_COLOR)
    assert out.shape[0] > 96
    assert tenhancer.enhance_snapshot_bytes(b"not a jpeg") is None


# --- (f) an async search on both apps with the real engines -----------------------------------

class RealApp(App):
    """``App`` on a real CPU engine of its package, at KW."""

    def __init__(self, kind, tmp_path, engine):
        kw = dict(KW, data_dir=str(tmp_path / kind / "data"), log_dir=str(tmp_path / kind / "logs"))
        if kind == "jax":
            ctx = JContext(cfg=j_load_config(**kw), engine=engine, camera_configs=[])
            self.router, _, self.ctx = j_build_app(ctx)
            self.http = jhttp
        else:
            ctx = TContext(cfg=load_config(**kw), engine=engine, camera_configs=[])
            self.router, _, self.ctx = t_build_app(ctx)
            self.http = thttp


def test_async_search_on_real_engines_equals_jax(engines, tmp_path):
    portrait = make_scene(DET, np.random.default_rng(3), max_faces=1, portrait=True)[0]
    png = cv2.imencode(".png", np.ascontiguousarray(portrait[..., ::-1]))[1].tobytes()
    results = []
    for kind, eng in zip(("jax", "torch"), engines):
        eng.gallery.clear()
        a = RealApp(kind, tmp_path, eng)
        try:
            body, ctype = _multipart({"target_name": "erin"}, {"file": ("erin.png", png, "image/png")})
            assert a.call("POST", "/face/upload", body=body, headers={"content-type": ctype})[0] == 200
            body, ctype = _multipart({}, {"file": ("q.png", png, "image/png")})
            status, data, _ = a.call("POST", "/async/face/search", body=body,
                                     headers={"content-type": ctype})
            assert status == 202
            results.append(_wait_job(a, data["job_id"], timeout=120))
        finally:
            a.ctx.shutdown()
            eng.gallery.clear()
    j, t = results
    assert j["status"] == t["status"] == "finished", (j.get("error"), t.get("error"))
    jb, tb = j["result"]["results"][0]["best_match"], t["result"]["results"][0]["best_match"]
    assert jb["target"] == tb["target"] == "erin"
    assert abs(jb["distance"] - tb["distance"]) <= 1e-4 + 1e-4


def test_async_job_runs_without_grad(tmp_path):
    """Grad mode is thread-local: the job's engine call runs under
    torch.no_grad() in the pool's worker thread."""
    eng = RecognitionEngine(load_config(**KW), device="cpu")
    ctx = TContext(cfg=load_config(**KW, data_dir=str(tmp_path / "d"), log_dir=str(tmp_path / "l")),
                   engine=eng, camera_configs=[])
    seen = []
    run = eng._run_stages

    def recording(*a, **k):
        seen.append((threading.current_thread().name, torch.is_grad_enabled()))
        return run(*a, **k)

    eng._run_stages = recording
    # the spoof weights the engine loaded are what the deepfake service reports
    assert eng.weights_loaded["spoof"] and ctx.deepfake.weights_loaded is True
    try:
        img = make_scene(DET, np.random.default_rng(3), max_faces=1, portrait=True)[0]
        job = ctx.async_tasks.enqueue_face_search(img)
        deadline = time.time() + 60
        while ctx.async_tasks.get_job(job["job_id"])["status"] not in ("finished", "failed"):
            assert time.time() < deadline
            time.sleep(0.05)
        assert ctx.async_tasks.get_job(job["job_id"])["status"] == "finished"
    finally:
        ctx.shutdown()
    with pytest.raises(RuntimeError):  # shutdown stopped the job pool
        ctx.async_tasks.enqueue_face_search(img)
    assert seen and all(not grad for _, grad in seen)
    assert all(name != threading.current_thread().name for name, _ in seen)


# --- (h) the deepfake path beside a running scan -----------------------------------------------

def test_deepfake_beside_a_scan_equals_alone(engines, clip):
    """A scan stream (DeltaEncoder payloads through submit_encoded) runs on
    the engine in one thread while the deepfake service processes the clip on
    the same engine in this one: the video's result equals the one processed
    alone, the scans equal the same stream run alone, and the delta state
    never desyncs."""
    _, eng = engines
    eng.gallery.clear()
    scenes = np.stack([make_scene(DET, np.random.default_rng(s), max_faces=2)[0] for s in (4, 5)])
    ticks = []
    for t in range(6):
        f = scenes.copy()
        f[:, 100:112, 10 * t: 10 * t + 12] = (200, 60, 90)
        ticks.append(tbatch.build_batch_i420({i: np.ascontiguousarray(x[..., ::-1])
                                              for i, x in enumerate(f)}, DET)[0])

    def scan_stream(stop=None, fetched=None):
        """The ticks' payloads in turn: once round, or on until `stop` is set
        and 2 scans are done, setting `fetched` at each fetch."""
        enc = tbatch.DeltaEncoder(block_bytes=128)
        outs = []
        while not ((stop.is_set() and len(outs) >= 2) if stop else len(outs) == len(ticks)):
            outs.append(eng.fetch(eng.submit_encoded(enc.encode(ticks[len(outs) % len(ticks)]))))
            if fetched is not None:
                fetched.set()
        return outs

    svc = TDeepfake(eng, max_frames=8)
    alone = svc.process_video(clip)
    eng.delta_stats.update(keyframes=0, deltas=0, desyncs=0)
    scans_alone = scan_stream()
    eng.delta_stats.update(keyframes=0, deltas=0, desyncs=0)
    stop, fetched, outs, errors = threading.Event(), threading.Event(), [], []

    def run():
        try:
            outs.extend(scan_stream(stop, fetched))
        except Exception as e:  # reported below
            errors.append(e)
            fetched.set()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    th = threading.Thread(target=run)
    try:
        th.start()
        # the video starts once the scan has fetched, so the two overlap
        assert fetched.wait(120), "the scan thread fetched no batch"
        beside = svc.process_video(clip)
    finally:
        stop.set()
        th.join(120)
        sys.setswitchinterval(interval)
    assert not th.is_alive() and not errors, errors
    assert len(outs) >= 2
    assert eng.delta_stats["desyncs"] == 0 and eng.delta_stats["keyframes"] == 1
    assert eng.delta_stats["deltas"] == len(outs) - 1
    for key in ("result", "confidence", "frames_sampled", "frames_with_faces", "statistics"):
        assert beside[key] == alone[key], key
    for a, b in zip(alone["frame_results"], beside["frame_results"]):
        assert a == b
    for i, (out, want) in enumerate(zip(outs, scans_alone)):
        for key in ("valid", "count", "best_idx", "boxes", "fake_prob"):
            assert np.array_equal(out[key], want[key]), (i, key)
