"""PyTorch port, on the card: each hand-written CUDA kernel against its plain
PyTorch version at the main path's shapes (masks, valid flags and counts bit
for bit, floats within 1e-3); the accuracy profile's embedder, embed
compaction and pipelined serving calls against the CPU or the unpipelined
calls; each trainer's f32 step against the CPU and the bf16 ArcFace loss
falling; the serving default (bf16) against the CPU engine at bf16; and the
deepfake service on the card against the CPU. The kernels have no CPU mode, so these tests are marked ``cuda`` and
skip where torch.cuda.is_available() is false.

The card machine has no JAX and tests/conftest.py imports it, so run them
there with:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q -p no:cacheprovider
"""

import importlib.util
import os
import queue
import threading

import numpy as np
import pytest
import torch

from frp_tpu_torch.config import load_config
from frp_tpu_torch.engine.batching import DeltaEncoder
from frp_tpu_torch.engine.pipeline import RecognitionEngine, build_pipeline
from frp_tpu_torch.models.iresnet import iresnet_forward
from frp_tpu_torch.models.params import convert_params, load_params
from frp_tpu_torch.ops import align_cuda, detection_cuda, nms_cuda
from frp_tpu_torch.ops.align import invert_similarity
from frp_tpu_torch.ops.anchors import generate_anchors
from frp_tpu_torch.ops.nms import nms_padded, nms_padded_batched, overlap_matrix
from frp_tpu_torch.platform.deepfake import DeepfakeService
from frp_tpu_torch.testing.payloads import crowd_payload
from frp_tpu_torch.testing.synthetic import make_scene, write_face_clip


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (run on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _random_head(rng, b, a, hot=48):
    loc = rng.normal(0, 0.4, size=(b, a, 4)).astype(np.float32)
    ldm = rng.normal(0, 0.4, size=(b, a, 10)).astype(np.float32)
    scores = rng.uniform(0, 0.25, size=(b, a)).astype(np.float32)
    for i in range(b):
        scores[i, rng.choice(a, size=hot, replace=False)] = rng.uniform(0.5, 1.0, size=hot)
    return loc, ldm, scores


def _head_payload(cuda, case, k):
    rng = np.random.default_rng(k)
    if case == "topk":  # random head outputs through the top-K, as the engine
        priors = torch.from_numpy(generate_anchors(640).copy()).to(cuda)
        loc, ldm, scores = (torch.from_numpy(x).to(cuda) for x in _random_head(rng, 8, priors.shape[0]))
        return detection_cuda.build_payload(loc, ldm, scores, priors, k)
    n_above = {"none": 0, "prefix": min(64, k // 2), "all": k, "scattered": k // 2}[case]
    return torch.from_numpy(crowd_payload(rng, 8, k, n_above, case == "scattered")).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["topk", "none", "prefix", "all", "scattered"])
@pytest.mark.parametrize("k,m", [(256, 16), (64, 8), (200, 16)])
def test_fused_head_kernel_matches_plain(cuda, k, m, case):
    payload = _head_payload(cuda, case, k)
    args = (m, 0.5, 0.4, 0.5, 640.0)
    got = detection_cuda.fused_head_kernel(payload, *args)
    want = detection_cuda.fused_head_plain(payload, *args)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got[..., 15].cpu().numpy(), want[..., 15].cpu().numpy())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0, atol=1e-3)
    if case == "none":
        assert not got.any()
    if case in ("all", "scattered"):
        assert got[..., 15].sum() >= 8  # a crowd: something is kept in every frame


def _similarities(th, sc, c, s):
    a, b = sc * np.cos(th), sc * np.sin(th)
    return np.stack([np.stack([a, -b, s / 2 - (a * c[..., 0] - b * c[..., 1])], -1),
                     np.stack([b, a, s / 2 - (b * c[..., 0] + a * c[..., 1])], -1)], -2)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,s", [
    (640, 640, 112), (640, 640, 96),  # the serving crop and a smaller one
    (360, 640, 112), (333, 517, 100),  # non-square frames; S a multiple of 4, not of 16
    (64, 80, 50),  # S no multiple of 4: scalar stores
])
def test_warp_kernel_matches_plain(cuda, h, w, s):
    rng = np.random.default_rng(1)
    frames = torch.from_numpy(rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)).to(cuda)
    # 16 faces of mixed scale and rotation, centres up to 40 px past the border
    th = rng.uniform(-0.7, 0.7, (2, 16))
    sc = rng.uniform(0.2, 2.5, (2, 16))
    c = rng.uniform([-40, -40], [w + 40, h + 40], (2, 16, 2))
    # faces 0-3 centred on each border, 4-5 on two corners
    c[:, 0], c[:, 1], c[:, 2], c[:, 3] = (0, h / 2), (w - 1, h / 2), (w / 2, 0), (w / 2, h - 1)
    c[:, 4], c[:, 5] = (0, 0), (w - 1, h - 1)
    # faces 6-7 several times the frame, 8 a tiny one
    sc[:, 6], sc[:, 7], sc[:, 8] = 0.3 * s / max(h, w), 0.05 * s / max(h, w), 4.0
    c[:, 6], c[:, 7] = (w / 2, h / 2), (w / 3, h / 3)
    inv = invert_similarity(torch.from_numpy(_similarities(th, sc, c, s).astype(np.float32)).to(cuda))
    got = align_cuda.warp_crops_kernel(frames, inv, s)
    want = align_cuda.warp_crops_plain(frames, inv, s)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0, atol=1e-3)


def _greedy_input(rng, b, k, case):
    """Effective overlap [b, k, k] of k boxes 16 to 160 px wide spread over a
    640 frame, and the above mask of one of five cases."""
    ctr = rng.uniform(0, 640, (b, k, 2))
    wh = rng.uniform(16, 160, (b, k, 2))
    boxes = torch.from_numpy(np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32))
    eff = overlap_matrix(boxes, 0.4, 0.5)
    above = {
        "none": np.zeros((b, k), bool),
        "all": np.ones((b, k), bool),
        "prefix": np.arange(k)[None] < rng.integers(1, k + 1, (b, 1)),
        "sparse": rng.random((b, k)) < 0.1,
        "scattered": rng.random((b, k)) < 0.6,
    }[case]
    return eff, torch.from_numpy(above)


def _hold_greedy(cuda, eff, above, want_from=None):
    """The kernel on (eff, above) against the plain version, bit for bit;
    `want_from` is the overlap the plain version reads, when it differs."""
    got = nms_cuda.greedy_suppress_kernel(eff.to(cuda), above.to(cuda), 1.0)
    torch.cuda.synchronize()
    want = nms_cuda.greedy_suppress_plain(eff if want_from is None else want_from, above, 1.0)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["none", "all", "prefix", "sparse", "scattered"])
@pytest.mark.parametrize("k,b", [(1, 8), (31, 20), (32, 1), (33, 8), (200, 20), (256, 8),
                                 (512, 1), (1000, 8), (1024, 20)])
def test_greedy_kernel_matches_plain(cuda, k, b, case):
    eff, above = _greedy_input(np.random.default_rng(k), b, k, case)
    want = _hold_greedy(cuda, eff, above)
    if case == "none":
        assert not want.any()
    if case == "all":
        assert want[:, 0].all()  # rank 0 is always kept


@pytest.mark.cuda
@pytest.mark.parametrize("k", [200, 512, 1023, 1024])
@pytest.mark.parametrize("junk", [float("nan"), 1e30])
def test_greedy_kernel_ignores_what_the_pass_cannot_read(cuda, k, junk):
    """NaN or 1e30 in every row and column of a candidate below the score
    threshold and everywhere at or left of the diagonal: the keep mask is
    that of the clean overlap."""
    eff, above = _greedy_input(np.random.default_rng(k + 1), 8, k, "scattered")
    both = above[:, :, None] & above[:, None, :]
    right = torch.triu(torch.ones(k, k, dtype=torch.bool), 1)
    dirty = torch.where(both & right, eff, torch.full_like(eff, junk))
    _hold_greedy(cuda, dirty, above, want_from=eff)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [33, 256, 1000])
@pytest.mark.parametrize("case", ["at_threshold", "chain", "rank0"])
def test_greedy_kernel_edge_cases(cuda, k, case):
    eff = torch.zeros((2, k, k))
    above = torch.ones((2, k), dtype=torch.bool)
    if case == "at_threshold":  # exactly 1.0 does not suppress; the next float does
        eff[0] = 1.0
        eff[1] = float(np.nextafter(np.float32(1.0), np.float32(2.0)))
    elif case == "chain":  # rank i suppresses only i + 1: every other rank is kept,
        # the fixed point's longest chain over each whole word
        i = torch.arange(k - 1)
        eff[:, i, i + 1] = 2.0
    else:  # rank 0 suppresses everything
        eff[:, 0, 1:] = 2.0
    want = _hold_greedy(cuda, eff, above)
    if case == "at_threshold":
        assert want[0].all() and int(want[1].sum()) == 1
    elif case == "chain":
        assert want[0].tolist() == [i % 2 == 0 for i in range(k)]
    else:
        assert int(want[0].sum()) == 1 and bool(want[0, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 512])
def test_greedy_kernel_takes_an_overlap_off_a_16_byte_boundary(cuda, k):
    """A view that starts 4 bytes into its storage: the 4-byte loads."""
    eff, above = _greedy_input(np.random.default_rng(k + 2), 3, k, "scattered")
    flat = torch.empty(eff.numel() + 1, device=cuda)
    view = flat[1:].view(eff.shape)
    view.copy_(eff)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    got = nms_cuda.greedy_suppress_kernel(view, above.to(cuda), 1.0)
    np.testing.assert_array_equal(
        got.cpu().numpy(), nms_cuda.greedy_suppress_plain(eff, above, 1.0).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("pre_topk", [64, 256, 512])
def test_nms_padded_batched_on_the_card_matches_cpu(cuda, pre_topk):
    """The port's batched NMS and its single-frame form on the card (kernel
    3) against the CPU (the plain greedy pass), at f32, with score ties."""
    rng = np.random.default_rng(pre_topk)
    a = 2000
    ctr = rng.uniform(0, 640, (3, a, 2))
    wh = rng.uniform(16, 160, (3, a, 2))
    boxes = torch.from_numpy(np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32))
    scores = torch.from_numpy(np.round(rng.uniform(0, 1, (3, a)), 2).astype(np.float32))
    ldm = torch.from_numpy(rng.uniform(0, 640, (3, a, 10)).astype(np.float32))
    kw = dict(pre_topk=pre_topk, max_out=16)
    launches = nms_cuda.LAUNCHES
    got = nms_padded_batched(boxes.to(cuda), scores.to(cuda), ldm.to(cuda), **kw)
    one = nms_padded(boxes[0].to(cuda), scores[0].to(cuda), ldm[0].to(cuda), **kw)
    assert nms_cuda.LAUNCHES == launches + 2
    want = nms_padded_batched(boxes, scores, ldm, **kw)
    for key in want:
        # the same f32 ops on the same values: the card's divisions round as the CPU's
        np.testing.assert_array_equal(got[key].cpu().numpy(), want[key].numpy(), err_msg=key)
        np.testing.assert_array_equal(one[key].cpu().numpy(), want[key][0].numpy(), err_msg=key)


@pytest.mark.cuda
def test_build_pipeline_on_the_card_matches_cpu(cuda):
    """The single-program pipeline at det 128, f32 (TF32 off): card against
    CPU, and the launches of a call."""
    kw = dict(det_size=128, max_faces=4, pre_nms_topk=64, conf_thresh=0.3,
              compute_dtype="float32")
    cfg = load_config(det_size=128, max_faces_per_frame=4, pre_nms_topk=64,
                      det_conf_threshold=0.3, compute_dtype="float32")
    frames = np.stack([make_scene(128, np.random.default_rng(s), max_faces=1, portrait=True)[0]
                       for s in (3, 5, 8)])
    gallery = np.random.default_rng(0).normal(size=(8, 128)).astype(np.float32)
    outs = []
    for dev in ("cpu", cuda):
        eng = RecognitionEngine(cfg, device=dev)  # the shipped weights, converted for dev
        params, priors = eng.params, eng._priors
        counts = (nms_cuda.LAUNCHES, align_cuda.LAUNCHES, detection_cuda.LAUNCHES)
        with torch.no_grad():
            out = build_pipeline(device=dev, **kw)(
                params, torch.from_numpy(frames).to(dev), torch.from_numpy(gallery).to(dev),
                torch.ones(8, dtype=torch.bool, device=dev), priors)
        if dev != "cpu":
            assert (nms_cuda.LAUNCHES, align_cuda.LAUNCHES, detection_cuda.LAUNCHES) == (
                counts[0] + 1, counts[1] + 1, counts[2])
        outs.append({k: v.cpu().numpy() for k, v in out.items()})
    want, got = outs
    assert want["count"].sum() >= 3
    for key in ("valid", "count", "best_idx", "is_match"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    v = want["valid"]
    # cuDNN and the CPU's convolutions sum in different orders: 1e-2 px on the
    # boxes, 1e-3 on unit-scale outputs
    for key, atol in (("boxes", 1e-2), ("landmarks", 1e-2), ("embeddings", 1e-3),
                      ("fake_prob", 1e-3), ("quality", 1e-3), ("best_distance", 1e-3)):
        np.testing.assert_allclose(got[key][v], want[key][v], rtol=0, atol=atol, err_msg=key)


@pytest.mark.cuda
def test_greedy_kernel_refuses_k_above_1024(cuda):
    eff = torch.zeros((1, 1025, 1025), device=cuda)
    with pytest.raises(ValueError):
        nms_cuda.greedy_suppress_kernel(eff, torch.ones((1, 1025), dtype=torch.bool, device=cuda))


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACCURACY = dict(embedder_arch="iresnet18", embed_flip_tta=True)


def _smoke():
    """chip_smoke.py's rendered scenes and I420 ticks."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_iresnet18_on_the_card_matches_cpu(cuda, dtype):
    """The shipped iresnet18 on 4 rendered faces: f32 (TF32 off) within 1e-3
    of the CPU at f32, bf16 at cosine >= 0.99."""
    host = load_params(os.path.join(REPO, "weights", "iresnet18.npz"))
    x = np.stack([make_scene(112, np.random.default_rng(30 + i), max_faces=1, portrait=True)[0]
                  for i in range(4)]).astype(np.float32)
    x = torch.from_numpy((x - 127.5) / 128.0)
    with torch.no_grad():
        want = iresnet_forward(convert_params(host), x).numpy()
        got = iresnet_forward(convert_params(host, cuda), x.to(cuda, getattr(torch, dtype))).cpu().numpy()
    assert got.shape == (4, 128) and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    else:
        assert (np.sum(got * want, 1) / np.linalg.norm(got, axis=1) / np.linalg.norm(want, axis=1)).min() >= 0.99


@pytest.mark.cuda
def test_accuracy_compaction_on_matches_off(cuda, monkeypatch):
    """The accuracy engine at full width on 8 rendered 640 scenes (128 slots:
    compaction picks a rung) against the same engine built with
    FRP_EMBED_COMPACT=0: valid, count, best_idx bit for bit, embeddings and
    fake_prob within 2e-2 (bf16; a smaller batch may take another cuDNN
    algorithm)."""
    smoke = _smoke()
    scenes = smoke.render_scenes(8, 640, 0)
    on = RecognitionEngine(load_config(**ACCURACY), device=cuda)
    monkeypatch.setenv("FRP_EMBED_COMPACT", "0")
    off = RecognitionEngine(load_config(**ACCURACY), device=cuda)
    monkeypatch.delenv("FRP_EMBED_COMPACT")
    want, got = off.process_frames(scenes), on.process_frames(scenes)
    assert 0 < want["count"].sum() <= 64
    for key in ("valid", "count", "best_idx"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    v = want["valid"]
    for key in ("embeddings", "fake_prob"):
        np.testing.assert_allclose(got[key][v], want[key][v], rtol=0, atol=2e-2, err_msg=key)
    assert not got["embeddings"][~v].any()


@pytest.mark.cuda
def test_put_payload_thread_and_fetch_many_match_fetch(cuda):
    """The default engine at full width over a delta stream: payloads uploaded
    by put_payload on a second thread, submitted here and fetched with
    fetch_many in groups of 3, against submit then fetch on the same engine
    (valid, count, best_idx, is_match bit for bit, floats within 1e-3)."""
    smoke = _smoke()
    scenes = smoke.render_scenes(8, 640, 0)
    enc = DeltaEncoder(block_bytes=128)
    payloads = [enc.encode(smoke.tick_batch(scenes, t)) for t in range(7)]
    eng = RecognitionEngine(load_config(), device=cuda)
    want = [eng.fetch(eng.submit_encoded(p)) for p in payloads]
    q: queue.Queue = queue.Queue()
    th = threading.Thread(target=lambda: [q.put(eng.put_payload(p)) for p in payloads])
    th.start()
    got, handles = [], []
    for i in range(len(payloads)):
        up = q.get(timeout=120)
        assert all(a.is_cuda for a in up[1:])
        handles.append(eng.submit_encoded(up))
        if len(handles) == 3 or i == len(payloads) - 1:
            got += eng.fetch_many(handles)
            handles = []
    th.join(timeout=60)
    assert not th.is_alive()
    assert eng.delta_stats["desyncs"] == 0
    for g, w in zip(got, want):
        for key in ("valid", "count", "best_idx", "is_match"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        v = w["valid"]
        for key in ("boxes", "landmarks", "scores", "best_distance", "fake_prob", "quality"):
            np.testing.assert_allclose(g[key][v], w[key][v], rtol=0, atol=1e-3, err_msg=key)
    np.testing.assert_array_equal(eng._delta_prev.cpu().numpy().reshape(8, -1),
                                  smoke.tick_batch(scenes, 6).reshape(8, -1))


def _clip_frames(tmp_path, width, height, frames):
    """A write_face_clip clip and every BGR frame of it, read in order."""
    import cv2

    path = str(tmp_path / "clip.avi")
    has_face = write_face_clip(path, width, height, frames, seed=0)
    cap = cv2.VideoCapture(path)
    out = []
    while len(out) < frames:
        ok, frame = cap.read()
        assert ok
        out.append(frame)
    cap.release()
    return path, out, has_face


@pytest.mark.cuda
def test_default_bf16_engine_on_the_card_matches_cpu_bf16(cuda, tmp_path):
    """The serving default (bf16) on the card against the CPU engine at bf16,
    on 8 rendered 640 scenes and 12 frames of a 1080p clip as the deepfake
    service batches them (chip_smoke.run_bf16_check): valid and count equal;
    every face that kept the same anchor on both within 1 px, at cosine >=
    0.99 and fake_prob within 0.02 of the CPU at bf16, and a face that kept
    another one a near tie (the two anchors' scores within 2e-4); best_idx
    equal on agreeing faces where the CPU's two nearest entries are 0.05
    apart; no verdict flips."""
    smoke = _smoke()
    _, frames, has_face = _clip_frames(tmp_path, 1920, 1080, 12)
    out = smoke.run_bf16_check(cuda, smoke.render_scenes(8, 640, 0), frames)
    for part in ("scenes", "video"):
        assert out[part]["ok"], (part, out[part])
    assert out["video"]["slots"] == sum(has_face)
    assert out["verdicts"][0] == out["verdicts"][1]


@pytest.mark.cuda
def test_deepfake_service_on_the_card_matches_cpu(cuda, tmp_path):
    """The deepfake service on the card engine against the CPU engine, both
    at f32 (TF32 off), on a 960x540 clip of 30 frames (10 sampled: chunks of
    8 and 2): per frame the face count, fake_prob within 1e-3 and boxes within
    1e-2 px; the same verdict and statistics (rounded to 4 decimals: one
    step)."""
    path, _, has_face = _clip_frames(tmp_path, 960, 540, 30)
    res = [DeepfakeService(RecognitionEngine(load_config(compute_dtype="float32"), device=d),
                           max_frames=10).process_video(path) for d in (cuda, "cpu")]
    got, want = res
    idx = DeepfakeService(None, max_frames=10)._sample_indices(30, False)
    assert want["frames_with_faces"] == sum(has_face[i] for i in idx) > 0
    for key in ("result", "confidence", "frames_sampled", "frames_with_faces"):
        assert got[key] == want[key], key
    for key, value in want["statistics"].items():
        assert abs(got["statistics"][key] - value) <= 1e-4 + 1e-9, key
    for g, w in zip(got["frame_results"], want["frame_results"]):
        assert g["faces"] == w["faces"] and (g["fake_prob"] is None) == (w["fake_prob"] is None)
        if w["fake_prob"] is not None:
            assert abs(g["fake_prob"] - w["fake_prob"]) <= 1e-3
            np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-2)


@pytest.mark.cuda
def test_deepfake_beside_a_scan_on_the_card(cuda, tmp_path):
    """The deepfake service and a delta scan stream on one card engine from
    two threads (both launch onto the default stream): the video's result
    equals the one processed alone (fake_prob within 1e-5), each scan equals
    the same payload's scan alone (valid, count, best_idx bit for bit, boxes
    within 1e-4 px), and the resident batch never desyncs."""
    smoke = _smoke()
    path, _, _ = _clip_frames(tmp_path, 960, 540, 30)
    eng = RecognitionEngine(load_config(compute_dtype="float32"), device=cuda)
    svc = DeepfakeService(eng, max_frames=10)
    scenes = smoke.render_scenes(8, 640, 0)
    ticks = [smoke.tick_batch(scenes, t) for t in range(6)]

    def scans(stop=None):
        enc = DeltaEncoder(block_bytes=128)
        outs = []
        while not (stop.is_set() if stop else len(outs) == len(ticks)):
            outs.append(eng.fetch(eng.submit_encoded(enc.encode(ticks[len(outs) % len(ticks)]))))
        return outs

    alone, scans_alone = svc.process_video(path), scans()
    eng.delta_stats.update(keyframes=0, deltas=0, desyncs=0)
    stop, outs = threading.Event(), []
    th = threading.Thread(target=lambda: outs.extend(scans(stop)))
    th.start()
    try:
        beside = svc.process_video(path)
    finally:
        stop.set()
        th.join(120)
    assert not th.is_alive() and len(outs) >= 2
    assert eng.delta_stats == {"keyframes": 1, "deltas": len(outs) - 1, "desyncs": 0}
    for key in ("result", "confidence", "frames_sampled", "frames_with_faces"):
        assert beside[key] == alone[key], key
    for a, b in zip(alone["frame_results"], beside["frame_results"]):
        assert a["faces"] == b["faces"]
        if a["fake_prob"] is not None:
            assert abs(a["fake_prob"] - b["fake_prob"]) <= 1e-5
    for got, want in zip(outs, scans_alone):
        for key in ("valid", "count", "best_idx"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-4)


# --- training ------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["arcface_mobilefacenet", "arcface_iresnet18", "spoof", "detector"])
def test_train_f32_step_on_cuda_equals_cpu(cuda, name):
    """One f32 step of each trainer (TF32 off) on the card and on the CPU
    from the same seed and batch, held as chip_smoke.train_parity holds it:
    the loss within 1e-4 relative, the accuracy equal, every parameter and
    running stat within 1e-4 absolute, the optimizer buffers as the CPU
    tests hold them against JAX."""
    errs = _smoke().train_parity(cuda, names={name})[name]
    assert errs["loss_rel"] <= 1e-4 and errs["params"] <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mobilefacenet", "iresnet18"])
def test_train_bf16_loss_falls_on_cuda(cuda, arch):
    """The default bf16 ArcFace step on the card at the tool's learning rate
    and margin: over 10 steps on one fixed batch of 16 uint8 crops the loss
    falls, and every metric is finite."""
    from frp_tpu_torch.train.arcface import ArcFaceTrainer

    smoke = _smoke()
    crops, labels, _ = smoke.arcface_batch(16, 5)
    tr = ArcFaceTrainer(num_classes=smoke.TRAIN_IDS, seed=0, learning_rate=0.05, arch=arch,
                        device=cuda)
    x, y = torch.from_numpy(crops).to(cuda), torch.from_numpy(labels).to(cuda)
    for _ in range(10):
        tr.train_step(x, y, sync=False)
    losses = [e["loss"] for e in tr.flush_metrics()]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


# --- a site's own weights ---------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("provenance", ["mixed", "onnx"])
def test_imported_iresnet50_512_engine_on_the_card_matches_cpu(cuda, tmp_path, provenance):
    """chip_smoke's phase-13 weights (a seeded w600k-style iresnet50-512
    embedder.onnx beside the shipped npz detector and spoof, or all three as
    ONNX): the engine at f32 (TF32 off) on the card against the CPU on
    phase 13's 2 parity scenes (640, two faces each), 4 slots: valid, count and best_idx bit for bit,
    boxes within 1e-2 px (chip_smoke.run_parity). The mixed engine keeps
    "same" padding, the all-ONNX one switches to "torch"."""
    from frp_tpu_torch.models import nn

    smoke = _smoke()
    dirs = smoke.write_weights_dirs(str(tmp_path))["dirs"]
    scenes = smoke.render_scenes(smoke.FRAMES, 640, smoke.SEED)[smoke.PARITY_SCENES]
    try:
        par = smoke.run_parity(cuda, scenes, {**smoke.IMPORTED, "max_faces_per_frame": 4,
                                              "weights_dir": dirs[provenance]})
        assert nn._PADDING_MODE == ("torch" if provenance == "onnx" else "same")
    finally:
        nn.set_padding_mode("same")
    assert par["faces"] > 0 and par["max_abs_err"]["boxes"] <= 1e-2


@pytest.mark.cuda
def test_calibrate_embedder_on_the_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """calibrate_embedder --device cuda against --device cpu at 2 identities
    x 2 variants, both at f32 (COMPUTE_DTYPE, TF32 off): the same detected
    scenes and pair counts, the scale and every metric within 1e-3."""
    from frp_tpu_torch.tools import calibrate_embedder

    monkeypatch.setenv("COMPUTE_DTYPE", "float32")
    monkeypatch.delenv("WEIGHTS_DIR", raising=False)
    monkeypatch.chdir(REPO)
    tiny = ["--identities", "2", "--variants", "2"]
    got = calibrate_embedder.main(tiny + ["--device", "cuda", "--out", str(tmp_path / "cuda.json")])
    want = calibrate_embedder.main(tiny + ["--device", "cpu", "--out", str(tmp_path / "cpu.json")])
    assert got["backend"].startswith("cuda (") and want["backend"] == "cpu"
    assert got["detected_scenes"] == want["detected_scenes"]
    assert abs(got["distance_scale"] / want["distance_scale"] - 1) <= 1e-3
    for key in ("metrics_e2e_raw", "metrics_e2e_calibrated", "metrics_crop_calibrated"):
        for k, v in want[key].items():
            assert abs(got[key][k] - v) <= 1e-3, (key, k, got[key][k], v)
