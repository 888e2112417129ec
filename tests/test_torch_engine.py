"""PyTorch port, engine: the port's RecognitionEngine on the CPU against the
JAX package's engine on one DeltaEncoder stream (keyframe + deltas, active
rows < det), at f32, plus the port engine's own contract (desync guard,
enrolment, device policy, weights and calibration checks, gallery)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from frp_tpu.config import load_config as j_load_config
from frp_tpu.engine.batching import DeltaEncoder, active_rows_for, build_batch_i420
from frp_tpu.engine.pipeline import RecognitionEngine as JEngine
from frp_tpu.engine.pipeline import unpack_packed as j_unpack
from frp_tpu.train.synthetic import make_scene

from frp_tpu_torch.config import load_config
from frp_tpu_torch.engine.batching import DeltaEncoder as TDeltaEncoder
from frp_tpu_torch.engine.gallery import DeviceGallery
from frp_tpu_torch.engine.pipeline import RecognitionEngine, unpack_packed
from frp_tpu_torch.models.iresnet import iresnet_forward

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = 128
KW = dict(det_size=DET, max_faces_per_frame=4, pre_nms_topk=64,
          det_conf_threshold=0.3, compute_dtype="float32")


@pytest.fixture(scope="module")
def engines():
    return JEngine(j_load_config(**KW), seed=0), RecognitionEngine(load_config(**KW), device="cpu")


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
            frames[i] = img[..., ::-1].copy()  # BGR, as cameras deliver
        rows = active_rows_for([f.shape[:2] for f in frames.values()], DET)
        assert rows is not None and rows < DET
        seq.append(build_batch_i420(frames, DET, active_rows=rows)[0])
    return seq


def test_delta_stream_matches_jax_engine(engines):
    jeng, teng = engines
    seq = _stream()
    # enrol the faces of the keyframe (and decoys) into BOTH galleries so
    # best_idx is a real decision. Each face is enrolled at its own norm:
    # an empty slot's zero query is nearest to the shortest entry, and equal
    # norms would make that a rounding tie instead of a decision.
    first = jeng.process_frames(seq[0], fmt="yuv420")
    assert first["valid"].sum() == 2, "the shipped detector missed a face"
    rng = np.random.default_rng(0)
    for g in (jeng.gallery, teng.gallery):
        g.clear()
    faces = first["embeddings"][first["valid"]] * np.array([[1.0], [0.9]], np.float32)
    for n, emb in enumerate([*faces, *rng.normal(size=(5, 128)).astype(np.float32)]):
        jeng.gallery.add(f"id{n}", emb)
        teng.gallery.add(f"id{n}", emb)

    ej, et = DeltaEncoder(block_bytes=128), TDeltaEncoder(block_bytes=128)
    host_prev = None
    kinds = []
    for batch in seq:
        pj, pt = ej.encode(batch), et.encode(batch)
        kinds.append(pt[0])
        want = jeng.fetch(jeng.submit_encoded(pj))
        got = teng.fetch(teng.submit_encoded(pt))
        for key in ("valid", "count", "best_idx", "is_match"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        v = want["valid"]
        for key, atol in (("boxes", 1e-2), ("landmarks", 1e-2), ("scores", 1e-4),
                          ("fake_prob", 1e-3), ("quality", 1e-2), ("blur_score", 1e-2),
                          ("best_distance", 1e-4)):
            np.testing.assert_allclose(got[key][v], want[key][v], rtol=0, atol=atol, err_msg=key)
        # the resident batch is what DeltaEncoder.apply_host rebuilds
        flat = batch.reshape(batch.shape[0], -1)
        host_prev = flat.copy() if pt[0] == "raw" else DeltaEncoder.apply_host(host_prev, pt[1], pt[2])
        np.testing.assert_array_equal(host_prev, flat)
        np.testing.assert_array_equal(teng._delta_prev.numpy().reshape(flat.shape), host_prev)
    assert kinds == ["raw", "delta", "delta"]
    assert teng.delta_stats == {"keyframes": 1, "deltas": 2, "desyncs": 0}
    for g in (jeng.gallery, teng.gallery):
        g.clear()


def test_full_tree_matches_jax_on_rgb(engines):
    jeng, teng = engines
    imgs = np.stack([make_scene(DET, np.random.default_rng(s), max_faces=2, portrait=s == 5)[0]
                     for s in (5, 9)])
    want, got = jeng.process_frames(imgs), teng.process_frames(imgs)
    assert want["count"].sum() > 0
    assert set(want) == set(got)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    # f32 embeddings through two conv implementations: 1e-4
    np.testing.assert_allclose(got["embeddings"][v], want["embeddings"][v], atol=1e-4)
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], atol=1e-2)


def test_desync_guard_and_keyframe_copy(engines):
    _, teng = engines
    seq = _stream(n=3)
    enc = TDeltaEncoder(block_bytes=128)
    key = seq[0].copy()
    teng.fetch(teng.submit_encoded(enc.encode(key)))
    key[:] = 0  # the caller reuses its buffer: the resident batch must not change
    np.testing.assert_array_equal(teng._delta_prev.numpy(), seq[0])
    enc.encode(seq[1])  # payload dropped on the way
    with pytest.raises(RuntimeError, match="desync"):
        teng.submit_encoded(enc.encode(seq[2]))
    assert teng.delta_stats["desyncs"] == 1
    fresh = RecognitionEngine(load_config(**KW), device="cpu")
    with pytest.raises(RuntimeError, match="before any raw keyframe"):
        fresh.submit_encoded(("delta", np.full((2, 4), -1, np.int32), np.zeros((2, 4, 128), np.uint8)))


def test_enrolled_face_matches_next_scan(engines):
    _, teng = engines
    img = make_scene(DET, np.random.default_rng(5), max_faces=1, portrait=True)[0]
    faces = teng.encode_image(img)
    assert len(faces) >= 1
    teng.gallery.clear()
    teng.gallery.add("someone", faces[0]["embedding"])
    out = teng.fetch(teng.submit(np.stack([img, img[:, ::-1]])))
    i = int(np.argmax(out["valid"][0]))
    assert out["is_match"][0, i] and out["gallery_names"][out["best_idx"][0, i]] == "someone"
    assert out["best_distance"][0, i] < 1e-3
    teng.gallery.clear()


def test_encode_image_letterboxes_non_square(engines):
    jeng, teng = engines
    img = make_scene(96, np.random.default_rng(5), max_faces=1, portrait=True)[0]
    img = np.concatenate([img, img[:, :40]], axis=1)  # 96 x 136
    want, got = jeng.encode_image(img), teng.encode_image(img)
    assert len(got) == len(want) >= 1
    np.testing.assert_allclose(got[0]["box"], want[0]["box"], atol=1e-2)


def test_engine_defaults_to_cuda_and_refuses_cpu_fallback():
    assert not torch.cuda.is_available()  # this suite runs on a CPU host
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RecognitionEngine(load_config(**KW))


def test_accuracy_profile_not_ported_raises():
    """The accuracy profile's engine builds on the shipped iresnet18, and its
    embedder's training forward (batch-statistics BN), once the part of the
    profile not ported, equals the JAX package's on the same weights: the
    embeddings and every BN unit's new running stats (atol 1e-4, as
    tests/test_torch_iresnet.py holds the forward)."""
    from frp_tpu.models.iresnet import iresnet_forward as j_iresnet_forward
    from frp_tpu.models.params import load_params as j_load_params

    eng = RecognitionEngine(load_config(**KW, embedder_arch="iresnet18"), device="cpu")
    assert eng.weights_loaded["embedder"].endswith("iresnet18.npz")
    imgs = np.stack([make_scene(112, np.random.default_rng(s), max_faces=1, portrait=True)[0]
                     for s in (1, 2, 3, 4)])
    x = (imgs.astype(np.float32) - 127.5) / 128.0
    got, got_stats = iresnet_forward(eng.params["embedder"], torch.from_numpy(x), train=True)
    want, want_stats = j_iresnet_forward(
        j_load_params(os.path.join(REPO, "weights", "iresnet18.npz")), x, train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert set(got_stats) == set(want_stats) and ("head_bn",) in got_stats
    for path, st in want_stats.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(got_stats[path][k].numpy(), np.asarray(st[k]), rtol=1e-4,
                                       atol=1e-4, err_msg=str(path))


def _weights_copy(tmp_path):
    wd = tmp_path / "w"
    wd.mkdir()
    for name in ("retinaface_synthetic.npz", "mobilefacenet.npz", "spoof.npz", "calibration.json"):
        shutil.copy(os.path.join(REPO, "weights", name), wd / name)
    return wd


def test_onnx_candidate_raises(tmp_path):
    """An unreadable ONNX candidate raises in the loader, and the engine
    falls through to the next candidate (the ONNX path itself is held in
    tests/test_torch_onnx.py)."""
    from frp_tpu_torch.engine.pipeline import load_any
    from frp_tpu_torch.models import nn
    from frp_tpu_torch.models.retinaface import init_retinaface

    wd = _weights_copy(tmp_path)
    (wd / "retinaface.onnx").write_bytes(b"\0")
    with pytest.raises(ValueError, match="onnx"):
        load_any(str(wd / "retinaface.onnx"), init_retinaface(0))
    mode = nn._PADDING_MODE
    eng = RecognitionEngine(load_config(**KW, weights_dir=str(wd)), device="cpu")
    assert eng.weights_loaded["detector"] == str(wd / "retinaface_synthetic.npz")
    assert nn._PADDING_MODE == mode


def test_stale_calibration_refused(tmp_path):
    wd = _weights_copy(tmp_path)
    eng = RecognitionEngine(load_config(**KW, weights_dir=str(wd)), device="cpu")
    assert eng.weights_loaded["embedder"] == str(wd / "mobilefacenet.npz")
    cal = json.loads((wd / "calibration.json").read_text())
    assert eng.distance_scale == pytest.approx(cal["distance_scale"])
    cal["weights_sha256"] = "0" * 64
    (wd / "calibration.json").write_text(json.dumps(cal))
    with pytest.raises(RuntimeError, match="calibrated for"):
        RecognitionEngine(load_config(**KW, weights_dir=str(wd)), device="cpu")
    eng = RecognitionEngine(load_config(**KW, weights_dir=str(wd)), device="cpu",
                            allow_stale_calibration=True)
    assert eng.distance_scale == 1.0


def test_structure_mismatch_falls_through(tmp_path):
    wd = _weights_copy(tmp_path)
    np.savez(wd / "retinaface.npz", **{"stem/conv/w": np.zeros((3, 3, 3, 8), np.float32)})
    eng = RecognitionEngine(load_config(**KW, weights_dir=str(wd)), device="cpu")
    assert eng.weights_loaded["detector"] == str(wd / "retinaface_synthetic.npz")


def test_gallery_capacity_swap_remove_and_snapshot():
    g = DeviceGallery(embed_dim=4, capacity=2)
    for i in range(5):
        g.add(f"p{i}", np.full(4, i, np.float32))
    assert g.capacity == 8 and len(g) == 5
    mat, valid, names = g.device_view()
    assert g.remove("p1") and not g.remove("nobody")
    assert g.name_of(1) == "p4" and g.names == ["p0", "p4", "p2", "p3"]
    # the snapshot taken before the removal is unchanged
    assert names == ["p0", "p1", "p2", "p3", "p4"] and float(mat[1, 0]) == 1.0
    mat2, valid2, _ = g.device_view()
    assert float(mat2[1, 0]) == 4.0 and int(valid2.sum()) == 4
    g.clear()
    assert len(g) == 0 and not g.device_view()[1].any()
    with pytest.raises(ValueError):
        g.add("x", np.zeros(3))


def test_unpack_packed_matches_jax():
    arr = np.random.default_rng(0).uniform(0, 2, (2, 4, 22)).astype(np.float32)
    a, b = unpack_packed(arr), j_unpack(arr)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
