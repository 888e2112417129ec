"""PyTorch port: the inputs that chip_smoke.py builds for its kernel checks
are what its docstrings say, checked here on the CPU (the checks themselves
need the card)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from frp_tpu_torch.ops import align_cuda
from frp_tpu_torch.ops.decode import decode_boxes
from frp_tpu_torch.ops.nms import overlap_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs its files in parallel worker processes: two intra-op
    threads a test keep those from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("crowd,above,least_share", [(False, 64, 0.0), (True, 256, 0.3)])
def test_head_payload_is_sorted_and_has_its_share_above(smoke, crowd, above, least_share):
    payload = smoke.head_payload(torch.device("cpu"), crowd)
    assert payload.shape == (8, 256, 19) and payload.dtype == torch.float32
    score = payload[..., 18]
    assert bool((score[:, :-1] >= score[:, 1:]).all())  # rows sorted by score
    assert ((score >= 0.5).sum(1) == above).all()
    boxes = decode_boxes(payload[..., 0:4], payload[..., 14:18], 640.0)
    meet = torch.triu(overlap_matrix(boxes, 0.4, 0.5) > 0, 1)
    assert float(meet.sum()) / (8 * 256 * 255 / 2) >= least_share


def test_face_matrices_put_the_centre_on_the_crop_centre(smoke):
    rng = np.random.default_rng(0)
    th, sc = rng.uniform(-0.7, 0.7, (2, 3)), rng.uniform(0.2, 2.5, (2, 3))
    c = rng.uniform(0, 640, (2, 3, 2))
    mats = smoke.face_matrices(th, sc, c, 112)
    assert mats.shape == (2, 3, 2, 3) and mats.dtype == np.float32
    mapped = np.einsum("bmij,bmj->bmi", mats[..., :2], c) + mats[..., 2]
    np.testing.assert_allclose(mapped, 56.0, atol=1e-3)
    np.testing.assert_allclose(np.hypot(mats[..., 0, 0], mats[..., 1, 0]), sc, rtol=1e-5)


def test_warp_faces_sample_inside_and_past_the_frame(smoke):
    inv = smoke.warp_faces(torch.device("cpu"), 2, 96, 128, m=16, s=32)
    assert inv.shape == (2, 16, 2, 3)
    frames = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 96, 128, 3), dtype=np.uint8))
    crops = align_cuda.warp_crops(frames, inv, 32)
    assert crops.shape == (2, 16, 32, 32, 3) and bool(torch.isfinite(crops).all())
    # faces 0 to 3 are centred on a border: half of each crop is the clamped edge
    centre = inv[:, :4, :, :2] @ torch.tensor([16.0, 16.0]) + inv[:, :4, :, 2]
    assert bool((centre[:, 0, 0].abs() < 1e-3).all()) and bool(((centre[:, 1, 0] - 127).abs() < 1e-3).all())


@pytest.mark.parametrize("case,lo,hi", [("smoke", 0.5, 0.7), ("sparse", 0.04, 0.16), ("crowd", 1.0, 1.0)])
def test_greedy_input_has_its_share_above(smoke, case, lo, hi):
    from frp_tpu_torch.ops import nms_cuda

    eff, above = smoke.greedy_input(torch.device("cpu"), 128, case)
    assert eff.shape == (8, 128, 128) and eff.dtype == torch.float32
    assert above.shape == (8, 128) and above.dtype == torch.bool
    assert lo <= float(above.float().mean()) <= hi
    keep = nms_cuda.greedy_suppress(eff, above, 1.0)
    kept, n_above = int(keep.sum()), int(above.sum())
    assert 0 < kept < n_above  # the pass has something to suppress
    if case == "crowd":  # four centres a frame: most of a crowd goes
        assert kept < n_above / 2


def test_pipelined_phase_runs_on_the_cpu(smoke):
    """Phase 9 at det 128 on the CPU: every pass equals the first and the
    delta rungs are precompiled (the timing and the launch counts need the
    card)."""
    profile = dict(smoke.PROFILE, det_size=128, max_faces_per_frame=4, pre_nms_topk=64,
                   det_conf_threshold=0.3, compute_dtype="float32")
    scenes = smoke.render_scenes(2, 128, 0)
    out = smoke.run_pipelined(torch.device("cpu"), scenes, profile, ticks=4, group=2)
    assert out["rungs"] == 4 and out["batches"] == 4 * 5 + 4
    assert set(out["ms_per_batch"]) == {"serial", "piped"} and len(out["ms_per_batch"]["piped"]) == 2
    assert all(err == 0.0 for err in out["max_abs_err"].values())


def test_platform_phase_runs_on_the_cpu(smoke, monkeypatch):
    """Phase 10 at det 192 on the CPU, 2 synthetic 192x192 cameras: every scan
    over the socket scans both cameras and matches the enrolled face on
    camera 0, alerts and tracking records land in the store, deltas flow
    without a desync; the parity half runs two CPU contexts (the launch
    counts and device times need the card)."""
    monkeypatch.setattr(smoke, "PLATFORM_CAMERAS", 2)
    monkeypatch.setattr(smoke, "PLATFORM_SOURCE", (192, 192))
    kw = dict(det_size=192, max_faces_per_frame=4, pre_nms_topk=64, det_conf_threshold=0.3,
              compute_dtype="float32", min_face_quality=0.0)
    dev = torch.device("cpu")
    out = smoke.run_platform(dev, 3, **kw)
    assert out["requests"] == 3 and out["min_faces"] > 0 and out["device_ms"] is None
    assert out["camera0_distance"][1] <= out["tolerance"]
    assert out["tracking"] and out["alerts"] and out["pushed"]
    assert out["delta"]["deltas"] > 0 and out["delta"]["desyncs"] == 0 and out["payload_kb"] > 0
    assert {"read", "letterbox", "encode", "submit", "fetch", "track"} <= set(out["parts_ms"])
    par = smoke.run_platform_parity(dev, **kw)
    assert par["detections"] > 0 and all(err == 0.0 for err in par["max_abs_err"].values())


def test_services_phase_runs_on_the_cpu(smoke, monkeypatch):
    """Phase 11 at det 320 on the CPU, a 640x360 clip (the face at the scale
    phase 11's 1080p clip has at det 640), 2 synthetic 192x192 cameras: the
    video's sampled frames, the faces found in those that hold one, 3 chunks,
    the cached second upload, the image, CCTV, async, FL, snapshot and page
    routes, and the f32 and bf16 halves on two CPU engines (launch counts and
    device times need the card)."""
    monkeypatch.setattr(smoke, "PLATFORM_CAMERAS", 2)
    monkeypatch.setattr(smoke, "PLATFORM_SOURCE", (192, 192))
    monkeypatch.setattr(smoke, "VIDEO_SIZE", (640, 360))
    kw = dict(det_size=320, max_faces_per_frame=4, pre_nms_topk=64, det_conf_threshold=0.3,
              compute_dtype="float32", min_face_quality=0.0)
    out = smoke.run_services(torch.device("cpu"), **kw)
    video = out["video"]
    assert video["frames_sampled"] == 20 and video["frames_with_faces"] == 17
    assert out["chunks"] == 3 and out["chunk_device_ms"] == []
    assert set(out["parts_ms"]) == {"read", "letterbox", "engine"} and out["cctv_ms"] > 0
    assert out["reads"]["in_order_frames"] == 60 and out["reads"]["mjpeg_seek_ms"] > 0
    assert out["job_distance"] <= 0.6 and out["image"]["faces"] >= 1
    assert out["f32"]["fake_prob"] == out["f32"]["box_px"] == 0.0
    for part in ("scenes", "video"):
        b = out["bf16"][part]
        assert b["ok"] and b["slots"] > 0 and b["valid_diff"] == b["best_idx_diff"] == 0
        assert b["off_bf16"] == b["anchor_flips"] == 0 and b["cos_min"] > 0.9999
    assert out["bf16"]["video"]["slots"] == 17


def test_embed_bound_counts_the_rung(smoke, monkeypatch):
    """The embed stage's FLOPs and bytes at det 128 on 16 frames x 4 slots
    follow the rung compaction picks, against the engine built with
    FRP_EMBED_COMPACT=0."""
    from frp_tpu_torch.config import load_config
    from frp_tpu_torch.engine.pipeline import RecognitionEngine

    cfg = load_config(det_size=128, max_faces_per_frame=4, pre_nms_topk=64,
                      det_conf_threshold=0.3, compute_dtype="float32")
    frames = np.stack([smoke.rgb_to_i420(s) for s in smoke.render_scenes(16, 128, 0)])
    on = smoke.embed_bound(RecognitionEngine(cfg, device="cpu"), frames, True)
    monkeypatch.setenv("FRP_EMBED_COMPACT", "0")
    off = smoke.embed_bound(RecognitionEngine(cfg, device="cpu"), frames, False)
    assert on["slots"] == off["slots"] == off["rung"] == 64 and 0 < on["faces"] <= on["rung"] < 64
    assert on["flops"] * 64 == pytest.approx(off["flops"] * on["rung"], rel=1e-6)
    assert on["bytes"] < off["bytes"] and on["bound_by"] == "operations"


class _CpuEvent:
    """torch.cuda.Event's timing calls on the host clock."""

    def __init__(self, **_):
        self.t = None

    def record(self):
        import time

        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_train_phase_runs_on_the_cpu(smoke, monkeypatch):
    """Phase 12 at tiny sizes on the CPU (det 128, batch 4, 4 identities, 12
    steps): each trainer's loss falls, the cuda-vs-cpu parity half runs (cpu
    against cpu here), the trained embedder serves through an engine and
    embed_scenes, and two fl_client runs aggregate through the port's server
    to the numpy mean (times, device-busy shares and launches need the
    card)."""
    for name, value in (("TRAIN_IDS", 4), ("TRAIN_BATCH", 4), ("TRAIN_STEPS", 12), ("TRAIN_WARM", 1),
                        ("BIG_BATCH", 8), ("DET_TRAIN", (128, 2)), ("PARITY_BATCH", 4), ("TICKS", 2),
                        ("PROFILE", dict(smoke.PROFILE, det_size=128, max_faces_per_frame=4,
                                         pre_nms_topk=64, det_conf_threshold=0.3))):
        monkeypatch.setattr(smoke, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", _CpuEvent)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(smoke, "busy_ms", lambda fn, n: (None, []))
    app = smoke.platform_app
    monkeypatch.setattr(smoke, "platform_app", lambda dev, d: app(
        dev, d, det_size=128, max_faces_per_frame=4, pre_nms_topk=64))
    dev = torch.device("cpu")
    from frp_tpu_torch.config import load_config
    from frp_tpu_torch.engine.pipeline import RecognitionEngine

    scenes = smoke.render_scenes(2, 128, 0)
    eng = RecognitionEngine(load_config(**smoke.PROFILE), device=dev)
    out = smoke.run_train(dev, scenes, eng, fl_args=("--batch", "4", "--identities", "2"))
    for r in (*out["arcface"].values(), out["spoof"], out["detector"]):
        assert r["loss"][1] < r["loss"][0] and r["flops"] > 0 and r["bound_ms"] > 0
        assert r["busy_ms"] is None and r["ms"] > 0
    assert set(out["arcface"]) == {"mobilefacenet", "iresnet18", "iresnet18_b8"}
    assert set(out["parity"]) == {"arcface_mobilefacenet", "arcface_iresnet18", "spoof", "detector"}
    assert all(e["params"] == 0.0 for e in out["parity"].values())
    assert out["serve"]["faces"] > 0 and out["serve"]["scenes"] >= 1
    assert out["fl"]["layers"] > 50 and len(out["fl"]["losses"]) == 2


def test_imported_weights_phase_runs_on_the_cpu(smoke, monkeypatch):
    """Phase 13 at a tiny size on the CPU (2 frames at det 128, 4 slots, an
    iresnet18 512-d w600k-style export, 3 ticks, the tools at 2 x 2 as child
    processes on the CPU): the tools' results, both engines' parity (cpu
    against cpu here), the mixed engine's bf16 rule, its scan and compaction
    runs, the all-ONNX engine's stream, and the padding mode back to "same"
    (times, device-busy shares and launches need the card)."""
    from frp_tpu_torch.models import nn

    small = dict(det_size=128, max_faces_per_frame=4, pre_nms_topk=64, det_conf_threshold=0.3)
    monkeypatch.setattr(smoke, "IMPORTED", dict(smoke.IMPORTED, embedder_arch="iresnet18", **small))
    monkeypatch.setattr(smoke, "TOOL_SIZE", ("--identities", "2", "--variants", "2"))
    monkeypatch.setattr(smoke, "PARITY_SCENES", [0, 1])  # faces at det 128
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", _CpuEvent)
    monkeypatch.setattr(smoke, "busy_ms", lambda fn, n: (None, []))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    scenes = smoke.render_scenes(2, 128, 0)
    out = smoke.run_imported(torch.device("cpu"), scenes, 2, 1)
    assert nn._PADDING_MODE == "same"
    tl = out["tools"]
    assert set(tl["seconds"]) == {"dry-run", "dry-run 512-d", "calibrate_embedder", "tiered_eval"}
    assert tl["backend"] == "cpu" and tl["scale"] > 0 and "shape mismatch" in tl["refused"]
    assert out["bf16"]["ok"] and out["bf16"]["slots"] > 0
    assert all(p["faces"] > 0 for p in out["parity"].values())
    assert out["scan"]["faces_per_batch"] > 0 and out["onnx_scan"]["faces_per_batch"] > 0
    comp = out["compaction"]
    # 2 frames x 4 slots is below compaction's 64 slots: both run all 8
    assert comp["bound"]["on"]["flops"] == comp["bound"]["off"]["flops"] > 0
    assert out["batches"] == out["scan"]["batches"] + comp["batches"] + out["onnx_scan"]["batches"]
