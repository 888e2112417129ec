"""PyTorch port, the serving platform, on the CPU against the JAX package:

- the host copies equal the JAX package's: the scan's batching over a
  5-tick 2-camera SyntheticSource sequence (arrays, BatchMeta, DeltaEncoder
  payloads, unmap_results) with the sources' change hints, without them
  (both packages' changed-band detectors), and without cv2 (both
  packages' native packers), bit for bit; SyntheticSource frames and
  hints bit for bit; the gallery's host and bulk calls; the matching and
  quality helpers; the schemas on valid and invalid documents;
- a store written by either package's platform hydrates into the other's
  gallery with equal names and embeddings;
- the port's app answers a request sequence (an upload, two scans, the
  alert list) as the JAX app does, both on real CPU engines at
  tests/test_torch_engine.py's KW over the same two pushed portraits: the
  same status codes, targets, cameras and alert priorities in the same
  order, the same tracking records, the engines' boxes within 1e-2 px and
  distances within 1e-4 (the responses round boxes to 0.1 px and distances
  to 1e-4, so those are held to one rounding step more).

The JAX package's native library comes from tests/test_torch_native.py's
``reference_framepack`` (a private build of its own source), never from its
racy shared path.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

import frp_tpu.engine.batching as jbatch
from frp_tpu.api import http as jhttp
from frp_tpu.api.main import build_app as j_build_app
from frp_tpu.config import load_config as j_load_config
from frp_tpu.engine.gallery import DeviceGallery as JGallery
from frp_tpu.engine.pipeline import RecognitionEngine as JEngine
from frp_tpu.ops import matching as jmatch
from frp_tpu.ops import quality as jquality
from frp_tpu.platform import schemas as jschemas
from frp_tpu.platform.context import AppContext as JContext
from frp_tpu.platform.state import SyntheticSource as JSource
from frp_tpu.train.synthetic import make_identity as j_make_identity
from frp_tpu.train.synthetic import make_scene
from frp_tpu.utils.native import get_framepack

import frp_tpu_torch.engine.batching as tbatch
from frp_tpu_torch.api import http as thttp
from frp_tpu_torch.api.main import build_app as t_build_app
from frp_tpu_torch.config import load_config
from frp_tpu_torch.engine.gallery import DeviceGallery as TGallery
from frp_tpu_torch.engine.pipeline import RecognitionEngine
from frp_tpu_torch.ops import matching as tmatch
from frp_tpu_torch.ops import quality as tquality
from frp_tpu_torch.platform import schemas as tschemas
from frp_tpu_torch.platform.context import AppContext as TContext
from frp_tpu_torch.platform.state import SyntheticSource as TSource
from frp_tpu_torch.testing.synthetic import make_identity as t_make_identity
from tests.fakes import FakeEngine
from tests.test_torch_native import reference_framepack  # noqa: F401  (fixture reuse)

DET = 128
KW = dict(det_size=DET, max_faces_per_frame=4, pre_nms_topk=64,
          det_conf_threshold=0.3, compute_dtype="float32")


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs its files in parallel worker processes: two intra-op
    threads a test keep those from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --- host copies ---------------------------------------------------------------

@pytest.mark.parametrize("w,h,seed", [(1920, 1080, 0), (256, 144, 1), (160, 120, 5), (64, 48, 2)])
def test_synthetic_source_frames_and_hints_bit_equal(w, h, seed):
    js, ts = JSource(w, h, seed), TSource(w, h, seed)
    for _ in range(3):
        (jok, jf), (tok, tf) = js.read(), ts.read()
        assert jok and tok and jf.dtype == tf.dtype == np.uint8
        assert np.array_equal(jf, tf)
        assert js.read_hints() == ts.read_hints()
        # a face was drawn (skin, eyes, nose, mouth), not a placeholder
        y0, y1 = ts.read_hints()[-1]
        assert len(np.unique(tf[y0:y1:2, ::2].reshape(-1, 3), axis=0)) > 3


def test_make_identity_equal():
    for seed in range(4):
        j, t = j_make_identity(seed), t_make_identity(seed)
        assert j.keys() == t.keys()
        for k in j:
            assert np.array_equal(np.asarray(j[k]), np.asarray(t[k])), k


def _sources(pkg_source):
    # 256 x 144 at det 128: the active rows (80) and an integer decimation
    # (k = 2), so the change-hint letterbox takes its banded path
    return {c: pkg_source(256, 144, seed=c) for c in (0, 1)}


def _scan_sequence(batch_mod, source_cls, mode, ticks=5):
    """What the camera route's scan builds over `ticks` reads of two
    synthetic cameras: (batch, meta, payload) a tick. mode "hints" passes the
    sources' change hints, "detector" none (each package's changed-band
    detector steps in), "no_cv2" runs without cv2."""
    sources = _sources(source_cls)
    state: dict = {}
    enc = batch_mod.DeltaEncoder(block_bytes=128)
    out = []
    for _ in range(ticks):
        frames = {c: s.read()[1] for c, s in sources.items()}
        hints = ({c: s.read_hints() for c, s in sources.items()}
                 if mode == "hints" else None)
        rows = batch_mod.active_rows_for([f.shape[:2] for f in frames.values()], DET)
        batch, meta = batch_mod.build_batch_i420_cached(
            frames, DET, state=state, hints=hints, active_rows=rows)
        payload = enc.encode(batch, hints=batch_mod.delta_hints_for(state, enc.block))
        out.append((batch.copy(), meta, payload))
    return out


def _assert_meta_equal(jm, tm):
    assert jm.cam_ids == tm.cam_ids and jm.orig_hw == tm.orig_hw
    for key in ("scales", "offsets", "frame_ok"):
        a, b = getattr(jm, key), getattr(tm, key)
        assert a.dtype == b.dtype and np.array_equal(a, b), key


@pytest.mark.usefixtures("reference_framepack")
@pytest.mark.parametrize("mode", ["hints", "detector", "no_cv2"])
def test_scan_batching_and_payloads_bit_equal(mode, monkeypatch):
    if mode == "no_cv2":
        assert get_framepack() is not None, "the JAX package's native packer did not build"
        monkeypatch.setattr(jbatch, "cv2", None)
        monkeypatch.setattr(tbatch, "cv2", None)
    jseq = _scan_sequence(jbatch, JSource, mode)
    tseq = _scan_sequence(tbatch, TSource, mode)
    kinds = []
    for (jb, jm, jp), (tb, tm, tp) in zip(jseq, tseq):
        assert np.array_equal(jb, tb)
        _assert_meta_equal(jm, tm)
        assert jp[0] == tp[0] and len(jp) == len(tp)
        for a, b in zip(jp[1:], tp[1:]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        kinds.append(tp[0])
    assert kinds[0] == "raw" and "delta" in kinds, kinds


def test_build_batch_and_unmap_results_equal():
    rng = np.random.default_rng(0)
    frames = {3: rng.integers(0, 255, (90, 160, 3), dtype=np.uint8), 5: None,
              7: rng.integers(0, 255, (128, 96, 3), dtype=np.uint8)}
    (jb, jm), (tb, tm) = (m.build_batch(frames, DET, slots=4) for m in (jbatch, tbatch))
    assert np.array_equal(jb, tb)
    _assert_meta_equal(jm, tm)
    b, m = 4, 3
    out = {
        "valid": rng.random((b, m)) < 0.6,
        "boxes": rng.uniform(0, DET, (b, m, 4)).astype(np.float32),
        "landmarks": rng.uniform(0, DET, (b, m, 10)).astype(np.float32),
        "scores": rng.random((b, m)).astype(np.float32),
        "best_idx": rng.integers(0, 5, (b, m)).astype(np.int32),
        "best_distance": rng.random((b, m)).astype(np.float32),
        "is_match": rng.random((b, m)) < 0.5,
        "embeddings": rng.normal(size=(b, m, 8)).astype(np.float32),
        "fake_prob": rng.random((b, m)).astype(np.float32),
        "quality": rng.random((b, m)).astype(np.float32),
    }
    jr, tr = jbatch.unmap_results(out, jm), tbatch.unmap_results(out, tm)
    assert [r["camera_id"] for r in jr] == [r["camera_id"] for r in tr] == [3, 7]
    for a, c in zip(jr, tr):
        assert len(a["faces"]) == len(c["faces"])
        for fa, fc in zip(a["faces"], c["faces"]):
            assert fa.keys() == fc.keys()
            for k in fa:
                assert np.array_equal(np.asarray(fa[k]), np.asarray(fc[k])), k


@pytest.mark.parametrize("shape,size,rows", [((1080, 1920), 640, 368), ((720, 1280), 640, 640),
                                              ((123, 77), 128, 128), ((97, 401), 128, 64)])
@pytest.mark.usefixtures("reference_framepack")
def test_letterbox_i420_equals_native_packer(shape, size, rows):
    from frp_tpu.utils.native import letterbox_i420_batch

    frame = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3), dtype=np.uint8)
    got, scale, off = tbatch.letterbox_i420(frame, size, rows)
    packed = letterbox_i420_batch([frame], size, rows=rows)
    assert packed is not None, "the JAX package's native packer did not build"
    want, scales, offsets = packed
    assert np.array_equal(got, want[0])
    assert np.float32(scale) == scales[0] and tuple(off) == tuple(offsets[0])


@pytest.mark.usefixtures("reference_framepack")
def test_hintless_cameras_take_the_detectors_bands():
    """A camera with no change hints is diffed by its change detector (the
    port's own framepack library): from the third scan on the cache takes
    the detector's bands, equal to the JAX package's on the same sequence,
    the batch equals build_batch_i420, and the slot's delta hint is the
    bands' block ranges, as JAX's."""
    got = {}
    for mod, source_cls in ((jbatch, JSource), (tbatch, TSource)):
        sources = _sources(source_cls)
        state: dict = {}
        seq = []
        for tick in range(4):
            frames = {c: s.read()[1] for c, s in sources.items()}
            rows = mod.active_rows_for([f.shape[:2] for f in frames.values()], DET)
            cached, _ = mod.build_batch_i420_cached(frames, DET, state, active_rows=rows)
            full, _ = mod.build_batch_i420(frames, DET, active_rows=rows)
            assert np.array_equal(cached, full)
            seq.append(([state["caches"][c].last_bands for c in sources],
                        mod.delta_hints_for(state, 128)))
        got[mod] = seq
    assert got[jbatch] == got[tbatch]
    bands = [b for b, _ in got[tbatch]]
    assert bands[0] == bands[1] == [None, None]  # the caches' first build, the detectors' first sight
    assert all(b for tick in bands[2:] for b in tick)  # then the detectors' bands
    assert all(h and h != [None, None] for _, h in got[tbatch][2:])


def test_gallery_host_and_bulk_calls_equal():
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(6, 16)).astype(np.float32)
    gals = [JGallery(embed_dim=16, capacity=4), TGallery(embed_dim=16, capacity=4)]
    for g in gals:
        assert g.load_entries({"a": emb[0], "b": emb[1], "bad": np.zeros(3)}) == 2
        assert g.load_matrix(["c", "a", "d", "c", "e"], emb[1:6]) == 3
        g.remove("a")
        g.add("b", emb[5])
    (jm, jn), (tm, tn) = (g.host_arrays() for g in gals)
    assert jn == tn == ["e", "b", "c", "d"] and np.array_equal(jm, tm)
    (jd, jv), (td, tv) = (g.device_arrays() for g in gals)
    assert np.array_equal(np.asarray(jd), td.numpy()) and np.array_equal(np.asarray(jv), tv.numpy())
    assert gals[0].capacity == gals[1].capacity == 8
    with pytest.raises(ValueError):
        gals[1].load_matrix(["x"], np.zeros((1, 3)))


def test_matching_and_quality_helpers_equal():
    for d in (-0.5, 0.0, 0.1, 0.39999, 0.4, 0.5, 0.59999, 0.6, 0.9, 1.0, 3.0):
        assert tmatch.confidence_level(d) == jmatch.confidence_level(d)
        assert tmatch.calibrate_confidence(d) == jmatch.calibrate_confidence(d)
    rng = np.random.default_rng(3)
    dists = rng.random(40)
    for k in (0, 1, 5, 40, 100):
        assert np.array_equal(tmatch.find_k_nearest(dists, k), jmatch.find_k_nearest(dists, k))
    img = rng.integers(0, 255, (120, 90, 3), dtype=np.uint8)
    for loc in ((10, 80, 100, 5), (0, 90, 120, 0), (50, 52, 53, 49), (60, 40, 50, 70)):
        assert tquality.assess_quality_host(img, loc) == jquality.assess_quality_host(img, loc)


SCHEMA_DOCS = {
    "FaceModel": [
        dict(target="bob", embedding="tok"),
        dict(target="bob", embedding="tok", updated_at="2026-01-01", quality_score=88.0),
        dict(target="", embedding="tok"),
        dict(target="x" * 129, embedding="tok"),
        dict(target="bob", embedding="tok", quality_score=101),
        dict(target="bob"),
    ],
    "TrackingRecordModel": [
        dict(person="a", camera_id=0, geo=(18.5, 73.8), distance=0.4, confidence="medium",
             timestamp="t"),
        dict(person="a", camera_id=-1, distance=0.4, confidence="high", timestamp="t"),
        dict(person="a", camera_id=0, geo=(200.0, 0.0), distance=0.1, confidence="high",
             timestamp="t"),
        dict(person="a", camera_id=0, distance=0.1, confidence="sure", timestamp="t"),
        dict(person="a", camera_id=0, distance=-0.1, confidence="low", timestamp="t",
             speed_kmh=3.0),
    ],
    "AlertLogModel": [
        dict(target="b", camera_id=1, distance=0.3, priority="high", timestamp="t"),
        dict(target="b", camera_id=1, distance=0.3, priority="urgent", timestamp="t"),
    ],
    "DeepfakeLogModel": [
        dict(result="fake", confidence="high", timestamp="t", boxes=[[1, 2, 3, 4]]),
        dict(result="fake", confidence="high", timestamp="t", boxes=[[1, 2, 3]]),
        dict(result="maybe", confidence="none", timestamp="t"),
    ],
    "ConfigModel": [dict(name="watchlist", data={"a": [1]}), dict(name="")],
}


@pytest.mark.parametrize("model", sorted(SCHEMA_DOCS))
def test_schemas_accept_and_reject_alike(model):
    seen = []
    for doc in SCHEMA_DOCS[model]:
        got = []
        for mod in (jschemas, tschemas):
            try:
                got.append(getattr(mod, model)(**doc).model_dump(exclude_none=True))
            except ValueError:
                got.append("rejected")
        assert got[0] == got[1], (model, doc)
        seen.append(got[1] == "rejected")
    assert any(seen) and not all(seen)


# --- the store ---------------------------------------------------------------------

def _cfg(loader, tmp_path, **kw):
    return loader(data_dir=str(tmp_path / "data"), log_dir=str(tmp_path / "logs"),
                  min_face_quality=0.0, **kw)


def _fake(gallery_cls):
    eng = FakeEngine()
    eng.gallery = gallery_cls(embed_dim=128)
    return eng


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_store_hydrates_across_packages(direction, tmp_path):
    """A data dir (encrypted faces collection, key file, backups) written by
    one package's platform hydrates into the other's gallery: switching
    backends keeps every enrolment."""
    first, second = (
        (JContext, j_load_config, JGallery), (TContext, load_config, TGallery))
    if direction == "port_to_jax":
        first, second = second, first
    rng = np.random.default_rng(4)
    embs = {f"id{i}": rng.normal(size=128).astype(np.float32) for i in range(3)}
    ctx = first[0](cfg=_cfg(first[1], tmp_path), engine=_fake(first[2]), camera_configs=[])
    assert ctx.cipher.available
    for name, e in embs.items():
        ctx.face_service.store_face(name, e)
    ctx.face_service.delete_face("id1")
    ctx.shutdown()
    ctx = second[0](cfg=_cfg(second[1], tmp_path), engine=_fake(second[2]), camera_configs=[])
    ctx.startup(start_health=False)
    mat, names = ctx.engine.gallery.host_arrays()
    ctx.shutdown()
    assert sorted(names) == ["id0", "id2"]
    for n, row in zip(names, mat):
        assert np.array_equal(row, embs[n])


# --- the two apps ------------------------------------------------------------------

def _multipart(fields: dict, files: dict) -> tuple[bytes, str]:
    boundary = "platformboundary"
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
             for k, v in fields.items()]
    for k, (fname, data, ctype) in files.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"; '
                     f'filename="{fname}"\r\nContent-Type: {ctype}\r\n\r\n'.encode() + data + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def _call(router, http, method, path, query=None, body=b"", headers=None):
    handler, params = router.resolve(method, path)
    req = http.Request(method, path, query or {}, dict(headers or {}), body, params)
    try:
        resp = asyncio.run(handler(req))
    except http.HTTPError as e:
        return e.status, e.detail
    return resp.status, json.loads(resp.body)


PORTRAIT_SEEDS = (3, 8)


def _app(kind, tmp_path):
    cams = [{"id": i, "name": f"Cam {i}", "geo": (18.5 + i, 73.8), "source": "push"}
            for i in range(2)]
    if kind == "jax":
        cfg = j_load_config(**KW, data_dir=str(tmp_path / "jax"), log_dir=str(tmp_path / "jl"))
        ctx = JContext(cfg=cfg, engine=JEngine(cfg, seed=0), camera_configs=cams)
        router, _, ctx = j_build_app(ctx)
        http = jhttp
    else:
        cfg = load_config(**KW, data_dir=str(tmp_path / "torch"), log_dir=str(tmp_path / "tl"))
        ctx = TContext(cfg=cfg, engine=RecognitionEngine(cfg, device="cpu"), camera_configs=cams)
        router, _, ctx = t_build_app(ctx)
        http = thttp
    fetched = []
    fetch = ctx.engine.fetch

    def recording_fetch(handle):
        out = fetch(handle)
        fetched.append(out)
        return out

    ctx.engine.fetch = recording_fetch
    for cam, seed in zip(ctx.cameras.all(), PORTRAIT_SEEDS):
        img = make_scene(DET, np.random.default_rng(seed), max_faces=1, portrait=True)[0]
        cam.source.push(np.ascontiguousarray(img[..., ::-1]))
    return router, http, ctx, fetched


def _requests(router, http):
    import cv2

    img = make_scene(DET, np.random.default_rng(PORTRAIT_SEEDS[0]), max_faces=1, portrait=True)[0]
    png = cv2.imencode(".png", np.ascontiguousarray(img[..., ::-1]))[1].tobytes()
    body, ctype = _multipart({"target_name": "alice"}, {"file": ("alice.png", png, "image/png")})
    got = [_call(router, http, "POST", "/face/upload", body=body,
                 headers={"content-type": ctype})]
    # max_faces other than 10 never takes the route's cached digest: both
    # requests scan, the second through a delta payload
    for _ in range(2):
        got.append(_call(router, http, "GET", "/camera/alerts", query={"max_faces": "9"}))
    got.append(_call(router, http, "GET", "/alerts"))
    return got


@pytest.fixture(scope="module")
def both_apps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("apps")
    torch.set_num_threads(2)
    res = {}
    for kind in ("jax", "torch"):
        router, http, ctx, fetched = _app(kind, tmp)
        res[kind] = (_requests(router, http), ctx, fetched)
        # the tracker stores on a one-thread pool, which shutdown cancels
        ctx.tracking._persist_pool.submit(lambda: None).result()
        ctx.shutdown()
    return res


def test_port_app_answers_as_jax_app(both_apps):
    (jresp, jctx, jout), (tresp, tctx, tout) = both_apps["jax"], both_apps["torch"]
    assert [r[0] for r in jresp] == [r[0] for r in tresp] == [200, 200, 200, 200]
    ju, tu = jresp[0][1], tresp[0][1]
    for key in ("status", "target", "face_count", "overridden", "success"):
        assert ju[key] == tu[key], key
    assert abs(ju["quality_detail"]["score"] - tu["quality_detail"]["score"]) <= 1.0
    for (_, js), (_, ts) in zip(jresp[1:3], tresp[1:3]):
        jd, td = js["detections"], ts["detections"]
        assert [(d["target"], d["camera_id"], d["recorded"]) for d in jd] == \
            [(d["target"], d["camera_id"], d["recorded"]) for d in td]
        assert [d["target"] for d in jd] == ["alice"]
        for a, b in zip(jd, td):
            assert np.abs(np.subtract(a["box"], b["box"])).max() <= 0.1 + 1e-2
            assert abs(a["distance"] - b["distance"]) <= 1e-4 + 1e-4
        assert [a["priority"] for a in js["new_alerts"]] == [a["priority"] for a in ts["new_alerts"]]
        assert js["metadata"]["cameras_scanned"] == ts["metadata"]["cameras_scanned"] == 2
        assert list(js["history"]) == list(ts["history"])
    jl, tl = jresp[3][1]["alerts"], tresp[3][1]["alerts"]
    key = ("target", "camera_id", "camera_name", "priority", "confidence", "geo")
    assert [[a[k] for k in key] for a in jl] == [[a[k] for k in key] for a in tl]
    assert len(tl) == 1 and tl[0]["target"] == "alice"
    # the engines' own outputs behind the scans
    assert len(jout) == len(tout) == 2
    for j, t in zip(jout, tout):
        for k in ("valid", "count", "best_idx", "is_match"):
            assert np.array_equal(j[k], t[k]), k
        v = j["valid"]
        assert np.abs(j["boxes"][v] - t["boxes"][v]).max() <= 1e-2
        assert np.abs(j["best_distance"][v] - t["best_distance"][v]).max() <= 1e-4
        assert j["gallery_names"] == t["gallery_names"] == ["alice"]
    assert tctx.engine.delta_stats == jctx.engine.delta_stats == \
        {"keyframes": 1, "deltas": 1, "desyncs": 0}
    # the tracking records in each store
    recs = []
    for ctx in (jctx, tctx):
        docs = sorted(ctx.db["tracking"].find({}), key=lambda d: d["timestamp"])
        recs.append([(d["person"], d["camera_id"], d["camera_name"], d["confidence"],
                      tuple(d["geo"]), round(d["distance"], 3)) for d in docs])
    assert recs[0] == recs[1] and len(recs[1]) == 1


# --- the engine calls the platform makes -----------------------------------------

@pytest.fixture(scope="module")
def engines():
    return JEngine(j_load_config(**KW), seed=0), RecognitionEngine(load_config(**KW), device="cpu")


def _portraits(seeds=PORTRAIT_SEEDS):
    return np.stack([make_scene(DET, np.random.default_rng(s), max_faces=1, portrait=True)[0]
                     for s in seeds])


def test_unpacked_submit_and_fetch_equal_jax(engines):
    """submit / submit_encoded with packed=False: the full result (embeddings
    and top-k included) as the JAX engine's, with gallery_names; fetch_many
    takes packed and unpacked handles together."""
    jeng, teng = engines
    frames = _portraits()
    for eng in engines:
        eng.gallery.clear()
        eng.gallery.add("p0", jeng.process_frames(frames[:1])["embeddings"][0, 0])
    want = jeng.fetch(jeng.submit(frames, packed=False))
    got = teng.fetch(teng.submit(frames, packed=False))
    assert set(got) == set(want)
    assert got["gallery_names"] == want["gallery_names"] == ["p0"]
    for k in ("valid", "count", "best_idx", "is_match", "topk_idx"):
        assert np.array_equal(got[k], want[k]), k
    v = want["valid"]
    assert v.any()
    for k, tol in (("boxes", 1e-2), ("landmarks", 1e-2), ("best_distance", 1e-4),
                   ("topk_distance", 1e-4), ("embeddings", 1e-4)):
        assert np.abs(got[k][v] - want[k][v]).max() <= tol, k
    many = teng.fetch_many([teng.submit(frames), teng.submit(frames, packed=False)])
    assert "embeddings" not in many[0] and "embeddings" in many[1]
    for out in many:
        assert out["gallery_names"] == ["p0"]
        for k in ("valid", "boxes", "best_idx", "best_distance", "quality"):
            assert np.array_equal(out[k], got[k]), k
    assert np.array_equal(many[1]["embeddings"], got["embeddings"])
    # the scan's call: an I420 keyframe, unpacked against packed
    i420 = build_i420(frames)
    full, packed = (teng.fetch(teng.submit_encoded(
        tbatch.DeltaEncoder(block_bytes=128).encode(i420), packed=p)) for p in (False, True))
    assert "embeddings" in full and full["gallery_names"] == ["p0"]
    for k in ("valid", "count", "boxes", "best_idx", "best_distance", "fake_prob"):
        assert np.array_equal(full[k], packed[k]), k


def test_to_host_one_copy_keeps_every_leaf(monkeypatch):
    """to_host copies a mix of dtypes and shapes (0-d, empty, bool, int8 to
    float64) with one device-to-host copy, each array equal to its own
    leaf's copy, of its dtype and shape, and aligned."""
    from frp_tpu_torch.engine import pipeline as tpipe

    g = torch.Generator().manual_seed(0)
    leaves = [torch.rand(3, 5, generator=g) > 0.5, torch.randint(-9, 9, (7,), dtype=torch.int8),
              torch.rand(2, 3, 4, generator=g), torch.tensor(3, dtype=torch.int32),
              torch.empty(0, 4), torch.randint(0, 99, (5, 2), dtype=torch.int64),
              torch.rand(3, dtype=torch.float64, generator=g), torch.rand(4, generator=g).half()]
    copies = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t: copies.append(t.shape) or real_cpu(t))
    got = tpipe.to_host(leaves)
    assert len(copies) == 1
    for t, a in zip(leaves, got):
        want = real_cpu(t).numpy()
        assert a.dtype == want.dtype and a.shape == want.shape and a.flags.aligned
        assert np.array_equal(a, want)
    assert tpipe.to_host([]) == []


def build_i420(frames):
    bgr = {i: np.ascontiguousarray(f[..., ::-1]) for i, f in enumerate(frames)}
    return tbatch.build_batch_i420(bgr, DET)[0]


def test_warmup_and_record_metrics(engines):
    _, teng = engines
    before = teng.metrics.as_dict()
    teng.warmup(1)
    teng.warmup(2, 96, 160)
    out = teng.process_frames(_portraits()[:1], record_metrics=False)
    assert out["valid"].any() and teng.metrics.as_dict() == before
    teng.process_frames(_portraits()[:1])
    assert teng.metrics.total_batches == before["total_batches"] + 1


def test_enrolment_between_scans_keeps_the_delta_state(engines):
    """encode_image (a B=1 RGB batch) between delta scans leaves the resident
    batch and its payload chain alone: the same scans with and without the
    enrolments in between give the same results, and no desync."""
    _, teng = engines
    frames = _portraits()
    ticks = []
    for t in range(4):
        f = frames.copy()
        f[:, 100:112, 10 * t : 10 * t + 12] = (200, 60, 90)
        ticks.append(build_i420(f))
    results = []
    for enrol in (False, True):
        enc = tbatch.DeltaEncoder(block_bytes=128)
        teng.delta_stats.update(keyframes=0, deltas=0, desyncs=0)
        outs = []
        for x in ticks:
            outs.append(teng.fetch(teng.submit_encoded(enc.encode(x))))
            if enrol:
                assert teng.encode_image(frames[1])
        resident = teng._delta_prev.clone()
        results.append((outs, resident))
        assert teng.delta_stats == {"keyframes": 1, "deltas": 3, "desyncs": 0}
    (a, ra), (b, rb) = results
    assert torch.equal(ra, rb)
    for x, y in zip(a, b):
        for k in ("valid", "boxes", "best_distance", "fake_prob"):
            assert np.array_equal(x[k], y[k]), k


@pytest.mark.parametrize("extra_reads", [0, 1, 6])
def test_reads_between_scans_leave_no_stale_pixels(extra_reads):
    """Other readers (a health probe, a snapshot, the MJPEG feed) read the
    cameras between two scans. The scan's change-hint letterbox, fed by
    Camera.read_with_hints, still equals a full letterbox of the frames it
    read; the JAX package's pairing of read() and read_hints() covers only
    the change from the last read and, after several reads in between,
    leaves the old face in the cache."""
    from frp_tpu_torch.platform.state import CameraRegistry

    def run(jax_pairing):
        reg = CameraRegistry()
        reg.init_cameras([{"id": c, "name": str(c), "source": "synthetic:512x288"}
                          for c in (0, 1)])
        state, stale = {}, 0
        for _ in range(5):
            frames, hints = {}, {}
            for cam in reg.all():
                for _ in range(extra_reads):
                    cam.read()
                if jax_pairing:
                    ok, frames[cam.id] = cam.read()
                    hints[cam.id] = cam.read_hints()
                else:
                    ok, frames[cam.id], hints[cam.id] = cam.read_with_hints()
            rows = tbatch.active_rows_for([f.shape[:2] for f in frames.values()], DET)
            cached, _ = tbatch.build_batch_i420_cached(frames, DET, state, hints=hints,
                                                       active_rows=rows)
            full, _ = tbatch.build_batch_i420(frames, DET, active_rows=rows)
            stale += int((cached != full).sum())
        return stale

    assert run(jax_pairing=False) == 0
    if extra_reads > 1:
        assert run(jax_pairing=True) > 0


def test_scan_read_after_another_read_gets_no_hints():
    """Camera.read_with_hints hands the scan the source's change hints only
    when nobody else read the camera since the scan's last read; after a
    health probe, a snapshot or a feed's read, a restart or a new source it
    hands None, a full letterbox."""
    from frp_tpu_torch.platform.state import Camera, CameraRegistry

    cam = Camera(0, "c", source="synthetic:64x48")
    ok, frame, bands = cam.read_with_hints()
    assert ok and frame.shape == (48, 64, 3) and bands is None  # first read
    for _ in range(3):
        ok, _, bands = cam.read_with_hints()
        assert ok and bands == cam.read_hints() and bands
    cam.read()
    assert cam.read_with_hints()[2] is None
    assert cam.read_with_hints()[2] == cam.read_hints()
    cam.restart()
    assert cam.read_with_hints()[2] is None
    reg = CameraRegistry()
    cam = reg.add(1, "d", source="synthetic:64x48")
    cam.read_with_hints()
    assert cam.read_with_hints()[2]
    reg.update(1, source="synthetic:64x48")
    assert cam.read_with_hints()[2] is None
