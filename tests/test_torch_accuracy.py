"""PyTorch port, the accuracy profile and the pipelined serving calls, on the
CPU against the JAX package:

- the port's iresnet18 + flip-TTA engine against the JAX engine over one
  DeltaEncoder stream and on RGB frames, at f32 (tolerances as
  tests/test_torch_engine.py: integer and mask outputs bit for bit, boxes and
  landmarks within 1e-2 px, scores and distances within 1e-4, quality within
  1e-2, fake_prob within 1e-3, embeddings within 1e-4);
- the arch- and mode-keyed distance-scale calibration;
- the embed stage's valid-slot compaction against the uncompacted stage and
  the JAX package's compacted stage (a tiny embedder in both, as
  tests/test_engine.py; 1e-5 on unit-scale outputs);
- ``put_payload``, ``fetch_many`` and ``precompile_delta_rungs`` against the
  unpipelined calls (bit for bit).
"""

import hashlib
import json
import logging
import os
import queue
import threading
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frp_tpu.config import load_config as j_load_config
from frp_tpu.engine.batching import DeltaEncoder, active_rows_for, build_batch_i420
from frp_tpu.engine.pipeline import RecognitionEngine as JEngine
from frp_tpu.engine.pipeline import build_stages as j_build_stages
from frp_tpu.engine.pipeline import embed_compact_rungs as j_rungs
from frp_tpu.train.synthetic import make_scene
from frp_tpu.utils.fingerprint import weights_fingerprint

from frp_tpu_torch.config import get_config, load_config, set_config
from frp_tpu_torch.engine import embed_compact_rungs
from frp_tpu_torch.engine.batching import DeltaEncoder as TDeltaEncoder
from frp_tpu_torch.engine.pipeline import RecognitionEngine, build_stages
from frp_tpu_torch.models.mobilenetv3 import init_mobilenetv3_small
from frp_tpu_torch.models.params import convert_params
from tests.test_torch_native import reference_framepack  # noqa: F401  (fixture reuse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs its files in parallel worker processes: two intra-op
    threads a test keep those from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
DET = 128
KW = dict(det_size=DET, max_faces_per_frame=4, pre_nms_topk=64,
          det_conf_threshold=0.3, compute_dtype="float32")
ACC = dict(KW, embedder_arch="iresnet18", embed_flip_tta=True)
FLOAT_TOL = (("boxes", 1e-2), ("landmarks", 1e-2), ("scores", 1e-4), ("fake_prob", 1e-3),
             ("quality", 1e-2), ("blur_score", 1e-2), ("best_distance", 1e-4))


def _stream(n=3, seeds=(3, 8)):
    """Wide I420 batches (128 x 168 frames: active rows 112 < det) of
    rendered portrait scenes, with a patch moving between ticks."""
    scenes = []
    for s in seeds:
        img = make_scene(DET, np.random.default_rng(s), max_faces=1, portrait=True)[0]
        scenes.append(np.concatenate([img, img[:, :40]], axis=1))
    seq = []
    for t in range(n):
        frames = {}
        for i, img in enumerate(scenes):
            img = img.copy()
            img[110:122, 8 + 12 * t : 20 + 12 * t] = (200, 40 * i, 90)
            frames[i] = img[..., ::-1].copy()
        rows = active_rows_for([f.shape[:2] for f in frames.values()], DET)
        seq.append(build_batch_i420(frames, DET, active_rows=rows)[0])
    return seq


def _hold(got, want):
    for key in ("valid", "count", "best_idx", "is_match"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    v = want["valid"]
    for key, atol in FLOAT_TOL:
        np.testing.assert_allclose(got[key][v], want[key][v], rtol=0, atol=atol, err_msg=key)


# --- the accuracy engine against the JAX package's ---------------------------

@pytest.fixture(scope="module")
def acc_engines():
    return JEngine(j_load_config(**ACC), seed=0), RecognitionEngine(load_config(**ACC), device="cpu")


@pytest.mark.usefixtures("reference_framepack")
def test_accuracy_delta_stream_matches_jax(acc_engines):
    jeng, teng = acc_engines
    assert teng.weights_loaded["embedder"].endswith("iresnet18.npz")
    assert teng.distance_scale == jeng.distance_scale == pytest.approx(0.81303)
    seq = _stream()
    first = jeng.process_frames(seq[0], fmt="yuv420")
    assert first["valid"].sum() == 2, "the shipped detector missed a face"
    faces = first["embeddings"][first["valid"]] * np.array([[1.0], [0.9]], np.float32)
    decoys = np.random.default_rng(0).normal(size=(5, 128)).astype(np.float32)
    for g in (jeng.gallery, teng.gallery):
        g.clear()
        for n, emb in enumerate([*faces, *decoys]):
            g.add(f"id{n}", emb)
    ej, et = DeltaEncoder(block_bytes=128), TDeltaEncoder(block_bytes=128)
    kinds = []
    for batch in seq:
        pj, pt = ej.encode(batch), et.encode(batch)
        kinds.append(pt[0])
        _hold(teng.fetch(teng.submit_encoded(pt)), jeng.fetch(jeng.submit_encoded(pj)))
        np.testing.assert_array_equal(teng._delta_prev.numpy(), batch)
    assert kinds == ["raw", "delta", "delta"]
    for g in (jeng.gallery, teng.gallery):
        g.clear()


def test_accuracy_full_tree_and_enrolment_match_jax(acc_engines):
    """process_frames on RGB (embeddings are the flip-TTA mean) and
    encode_image of one portrait."""
    jeng, teng = acc_engines
    imgs = np.stack([make_scene(DET, np.random.default_rng(s), max_faces=2, portrait=s == 5)[0]
                     for s in (5, 9)])
    want, got = jeng.process_frames(imgs), teng.process_frames(imgs)
    assert want["count"].sum() > 0 and set(want) == set(got)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    np.testing.assert_allclose(got["embeddings"][v], want["embeddings"][v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], rtol=0, atol=1e-2)
    # flip-TTA renormalises the mean: the scaled embedding's norm is the scale
    np.testing.assert_allclose(np.linalg.norm(got["embeddings"][v], axis=-1),
                               teng.distance_scale, rtol=1e-5)
    tf = teng.encode_image(imgs[0])
    assert len(tf) >= 1
    np.testing.assert_allclose(tf[0]["embedding"], got["embeddings"][0][v[0]][0], atol=1e-5)


def test_accuracy_profile_reaches_the_engine(monkeypatch):
    """FRP_PROFILE=accuracy through get_config() builds the iresnet18 + flip
    engine with its calibration."""
    monkeypatch.setenv("FRP_PROFILE", "accuracy")
    for var in ("EMBEDDER_ARCH", "EMBED_FLIP_TTA"):
        monkeypatch.delenv(var, raising=False)
    old = get_config()
    try:
        set_config(None)
        eng = RecognitionEngine(device="cpu")
    finally:
        set_config(old)
    assert (eng.cfg.embedder_arch, eng.cfg.embed_flip_tta) == ("iresnet18", True)
    assert eng.weights_loaded["embedder"].endswith("iresnet18.npz")
    assert eng.distance_scale == pytest.approx(0.81303)


# --- calibration --------------------------------------------------------------

def _cal_engine(cls, arch, flip, wd=os.path.join(REPO, "weights"), allow_stale=False):
    """An engine object holding only what _load_calibration reads."""
    eng = object.__new__(cls)
    eng.cfg = SimpleNamespace(embedder_arch=arch, embed_flip_tta=flip)
    eng.weights_loaded = {"embedder": os.path.join(wd, f"{arch}.npz"),
                          "detector": os.path.join(REPO, "weights", "retinaface_synthetic.npz")}
    eng._allow_stale_calibration = allow_stale
    return eng


@pytest.mark.parametrize("arch,flip,scale", [
    ("mobilefacenet", False, None), ("iresnet18", False, None), ("iresnet18", True, 0.81303)])
def test_shipped_distance_scale_equals_jax(arch, flip, scale):
    got = _cal_engine(RecognitionEngine, arch, flip)._load_calibration()
    want = _cal_engine(JEngine, arch, flip)._load_calibration()
    assert got == want != 1.0
    if scale is not None:
        assert got == pytest.approx(scale)


def _tmp_weights(tmp_path):
    emb = tmp_path / "iresnet18.npz"
    emb.write_bytes(b"weights-as-shipped")
    return str(tmp_path), weights_fingerprint(str(emb))


def test_mode_keyed_calibration_and_cross_mode_refused(tmp_path):
    """A flip engine loads only calibration_{arch}_flip.json and a non-flip
    engine never loads it; a renamed non-flip file does not cross modes."""
    wd, fp = _tmp_weights(tmp_path)
    (tmp_path / "calibration_iresnet18.json").write_text(json.dumps(
        {"distance_scale": 0.82, "weights_sha256": fp}))
    assert _cal_engine(RecognitionEngine, "iresnet18", False, wd)._load_calibration() == pytest.approx(0.82)
    assert _cal_engine(RecognitionEngine, "iresnet18", True, wd)._load_calibration() == 1.0
    (tmp_path / "calibration_iresnet18_flip.json").write_text(json.dumps(
        {"distance_scale": 0.82, "weights_sha256": fp}))  # renamed, no flip_tta field
    assert _cal_engine(RecognitionEngine, "iresnet18", True, wd)._load_calibration() == 1.0
    (tmp_path / "calibration_iresnet18_flip.json").write_text(json.dumps(
        {"distance_scale": 0.64, "flip_tta": True, "weights_sha256": fp}))
    assert _cal_engine(RecognitionEngine, "iresnet18", True, wd)._load_calibration() == pytest.approx(0.64)
    assert _cal_engine(RecognitionEngine, "iresnet18", False, wd)._load_calibration() == pytest.approx(0.82)


def test_stale_fingerprint_raises_or_runs_uncalibrated(tmp_path):
    wd, _ = _tmp_weights(tmp_path)
    stale = hashlib.sha256(b"weights-as-measured-last-round").hexdigest()
    (tmp_path / "calibration_iresnet18_flip.json").write_text(json.dumps(
        {"distance_scale": 0.64, "flip_tta": True, "weights_sha256": stale}))
    with pytest.raises(RuntimeError, match="--arch iresnet18 --flip"):
        _cal_engine(RecognitionEngine, "iresnet18", True, wd)._load_calibration()
    eng = _cal_engine(RecognitionEngine, "iresnet18", True, wd, allow_stale=True)
    assert eng._load_calibration() == 1.0


def test_missing_calibration_warns_for_non_default_mode(tmp_path, caplog):
    wd, _ = _tmp_weights(tmp_path)
    log = logging.getLogger("frp.engine")  # may not propagate to the root
    log.addHandler(caplog.handler)
    try:
        assert _cal_engine(RecognitionEngine, "iresnet18", True, wd)._load_calibration() == 1.0
    finally:
        log.removeHandler(caplog.handler)
    assert "no calibration_iresnet18_flip.json beside" in caplog.text


# --- embed compaction -----------------------------------------------------------

RAMP = np.linspace(-1.0, 1.0, 112, dtype=np.float32)


def _tiny_params(rng):
    return {"w": rng.normal(size=(6, 16)).astype(np.float32),
            "b": rng.normal(size=(16,)).astype(np.float32)}


def _j_tiny(p, x, train=False, normalize=True):
    """Depends on the crop's content and, through a ramp along W, on its
    mirror image: flip-TTA's second forward differs from the first."""
    ramp = jnp.asarray(RAMP)[None, None, :, None]
    pooled = jnp.concatenate([x.mean(axis=(1, 2)), (x * ramp).mean(axis=(1, 2))], -1)
    return jnp.tanh(pooled @ p["w"] + p["b"])


def _t_tiny(sizes):
    ramp = torch.from_numpy(RAMP)[None, None, :, None]

    def fwd(p, x):
        sizes.append(x.shape[0])
        pooled = torch.cat([x.mean(dim=(1, 2)), (x * ramp).mean(dim=(1, 2))], -1)
        return torch.tanh(pooled @ p["w"] + p["b"])
    return fwd


def test_embed_compact_rungs_match_jax(monkeypatch):
    for n in (32, 63, 64, 128, 200):
        assert embed_compact_rungs(n) == j_rungs(n)
    assert embed_compact_rungs(32) == []
    assert embed_compact_rungs(128) == [16, 64, 104]
    assert embed_compact_rungs(64) == [8, 32, 52]
    assert embed_compact_rungs(128, rung_env="64, 16,200") == [16, 64]
    monkeypatch.setenv("FRP_EMBED_COMPACT", "0")
    assert embed_compact_rungs(128) == [] == j_rungs(128)
    monkeypatch.setenv("FRP_EMBED_COMPACT", "1")
    monkeypatch.setenv("FRP_EMBED_RUNGS", "40")
    assert embed_compact_rungs(128) == [40] == j_rungs(128)


@pytest.mark.parametrize("flip", [False, True])
def test_embed_compaction_equals_plain_and_jax(monkeypatch, flip):
    rng = np.random.default_rng(0)
    tiny = _tiny_params(rng)
    b, m = 8, 8  # n = 64: rungs [8, 32, 52]
    kw = dict(det_size=DET, max_faces=m, compute_dtype="float32", flip_tta=flip)
    sizes_c, sizes_p = [], []
    embed_c = build_stages(device="cpu", embedder_forward=_t_tiny(sizes_c), **kw)["embed"]
    j_embed = j_build_stages(with_spoof=False, embedder_forward=_j_tiny, **kw)["embed"]
    monkeypatch.setenv("FRP_EMBED_COMPACT", "0")
    embed_p = build_stages(device="cpu", embedder_forward=_t_tiny(sizes_p), **kw)["embed"]
    monkeypatch.delenv("FRP_EMBED_COMPACT")  # read at build time: no effect now
    params = {"embedder": {k: torch.from_numpy(v) for k, v in tiny.items()},
              "spoof": convert_params(init_mobilenetv3_small(5, num_classes=2))}
    crops = rng.uniform(0, 255, (b, m, 112, 112, 3)).astype(np.float32)
    forwards = 2 if flip else 1
    for nv, k in ((0, 8), (5, 8), (8, 8), (33, 52), (52, 52), (53, 64), (64, 64)):
        valid = np.zeros(b * m, bool)
        valid[rng.permutation(b * m)[:nv]] = True
        valid = valid.reshape(b, m)
        args = (torch.from_numpy(crops), torch.from_numpy(valid), 1.3)
        del sizes_c[:], sizes_p[:]
        with torch.no_grad():
            out_c, out_p = embed_c(params, *args), embed_p(params, *args)
        assert sizes_c == [k] * forwards and sizes_p == [64] * forwards, nv
        want = np.asarray(j_embed({"embedder": tiny}, crops, valid, 1.3)["embeddings_flat"])
        for key in ("embeddings_flat", "fake_prob"):
            np.testing.assert_allclose(out_c[key].numpy(), out_p[key].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{key} nv={nv}")
        np.testing.assert_allclose(out_c["embeddings_flat"].numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"jax nv={nv}")
        inv = ~valid
        assert np.all(out_c["embeddings_flat"].numpy().reshape(b, m, -1)[inv] == 0)
        assert np.all(out_c["fake_prob"].numpy()[inv] == 0)


def test_embed_rungs_env_read_at_build_time(monkeypatch):
    monkeypatch.setenv("FRP_EMBED_RUNGS", "16")
    sizes = []
    embed = build_stages(device="cpu", det_size=DET, max_faces=8, compute_dtype="float32",
                         embedder_forward=_t_tiny(sizes))["embed"]
    monkeypatch.delenv("FRP_EMBED_RUNGS")
    params = {"embedder": {k: torch.from_numpy(v) for k, v in _tiny_params(np.random.default_rng(1)).items()},
              "spoof": convert_params(init_mobilenetv3_small(5, num_classes=2))}
    valid = torch.zeros((8, 8), dtype=torch.bool)
    valid[0, :5] = True
    with torch.no_grad():
        embed(params, torch.zeros((8, 8, 112, 112, 3)), valid)
        valid[:3] = True  # 24 valid: past the only rung, the whole batch
        embed(params, torch.zeros((8, 8, 112, 112, 3)), valid)
    assert sizes == [16, 64]


def test_engine_compaction_equals_uncompacted(monkeypatch):
    """The default engine at det 128 on 16 frames x 4 slots (n = 64: rungs
    8, 32, 52) against the same engine built with FRP_EMBED_COMPACT=0."""
    imgs = np.stack([make_scene(DET, np.random.default_rng(60 + i), max_faces=2, portrait=i % 3 == 0)[0]
                     for i in range(16)])
    on = _engine()
    monkeypatch.setenv("FRP_EMBED_COMPACT", "0")
    off = _engine()
    monkeypatch.delenv("FRP_EMBED_COMPACT")
    got, want = on.process_frames(imgs), off.process_frames(imgs)
    assert 0 < want["count"].sum() <= 52
    for key in ("valid", "count", "best_idx", "is_match"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    v = want["valid"]
    for key in ("embeddings", "fake_prob"):
        np.testing.assert_allclose(got[key][v], want[key][v], rtol=0, atol=1e-5, err_msg=key)
    assert not got["embeddings"][~v].any() and not got["fake_prob"][~v].any()


# --- pipelined calls ---------------------------------------------------------------

@pytest.fixture(scope="module")
def stream():
    seq = _stream(n=5)
    enc = TDeltaEncoder(block_bytes=128)
    payloads = [enc.encode(x) for x in seq]
    assert [p[0] for p in payloads] == ["raw"] + ["delta"] * 4
    return seq, payloads


def _engine():
    return RecognitionEngine(load_config(**KW), device="cpu")


def test_put_payload_fetch_many_equal_submit_fetch(stream, monkeypatch):
    seq, payloads = stream
    ref = _engine()
    want = [ref.fetch(ref.submit_encoded(p)) for p in payloads]

    eng = _engine()
    q: queue.Queue = queue.Queue()

    def transfer():
        for p in payloads:
            q.put(eng.put_payload(p))
    th = threading.Thread(target=transfer)
    th.start()
    handles = []
    for want_p in payloads:
        p = q.get(timeout=60)
        assert isinstance(p[1], torch.Tensor) and (p.enc_id, p.seq) == (want_p.enc_id, want_p.seq)
        handles.append(eng.submit_encoded(p))
    th.join(timeout=60)
    assert not th.is_alive()

    copies = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **k: copies.append(1) or real_cpu(t, *a, **k))
    got = eng.fetch_many(handles[:4]) + eng.fetch_many(handles[4:])
    monkeypatch.undo()
    assert len(copies) == 2  # one device-to-host copy a group
    assert eng.fetch_many([]) == []
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    np.testing.assert_array_equal(eng._delta_prev.numpy(), seq[-1])
    assert eng.delta_stats == {"keyframes": 1, "deltas": 4, "desyncs": 0}
    assert eng.metrics.total_batches == 5 and eng.metrics.total_frames == 10
    assert eng.metrics.total_faces == ref.metrics.total_faces


def test_put_payload_copies_the_keyframe_and_passes_tensors(stream):
    seq, payloads = stream
    eng = _engine()
    key = seq[0].copy()
    up = eng.put_payload(("raw", key))
    key[:] = 0  # the caller reuses its buffer: the uploaded keyframe keeps its bytes
    np.testing.assert_array_equal(up[1].numpy(), seq[0])
    again = eng.put_payload(up)
    assert again[1] is up[1]  # already uploaded: no second copy
    assert type(up) is tuple and type(again) is tuple  # an untagged payload stays untagged
    tagged = eng.put_payload(payloads[1])
    assert eng.put_payload(tagged)[2] is tagged[2] and eng.put_payload(tagged).seq == payloads[1].seq


def test_put_payload_keeps_the_desync_guard(stream):
    _, payloads = stream
    eng = _engine()
    ups = [eng.put_payload(p) for p in payloads[:3]]
    eng.fetch(eng.submit_encoded(ups[0]))
    with pytest.raises(RuntimeError, match="desync"):
        eng.submit_encoded(ups[2])  # ups[1] dropped
    assert eng.delta_stats["desyncs"] == 1


def test_precompile_delta_rungs_keeps_the_resident_batch(stream):
    seq, payloads = stream
    eng = _engine()
    assert eng.precompile_delta_rungs() == 0  # no keyframe yet
    eng.fetch(eng.submit_encoded(payloads[0]))
    before = eng._delta_prev.clone()
    assert eng.precompile_delta_rungs() == len(TDeltaEncoder.LADDER)
    assert eng.precompile_delta_rungs(block=100) == 0  # 168 x 128 bytes a frame: no alignment
    assert torch.equal(eng._delta_prev, before)
    assert eng.delta_stats == {"keyframes": 1, "deltas": 4, "desyncs": 0}
    # the untagged no-op payloads kept the live stream's tag: the next
    # payload in order goes through, one out of order raises
    eng.fetch(eng.submit_encoded(payloads[1]))
    np.testing.assert_array_equal(eng._delta_prev.numpy(), seq[1])
    with pytest.raises(RuntimeError, match="desync"):
        eng.submit_encoded(payloads[3])
