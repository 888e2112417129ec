"""PyTorch port, on the card: each hand-written CUDA kernel against its plain
PyTorch version at the main path's shapes (masks, valid flags and counts bit
for bit, floats within 1e-3); the accuracy profile's embedder, embed
compaction and pipelined serving calls against the CPU or the unpipelined
calls; the ViT forward through its add-LN pass against the float32
reference; each trainer's f32 step against the CPU and the bf16 ArcFace loss
falling; the serving default (bf16) against the CPU engine at bf16; and the
deepfake service on the card against the CPU; the engine over a mesh of the
card against the unsharded engine, and the ArcFace step in a one-rank NCCL
group against one process; ``build_pipeline``'s switches and the engine
without spoof against the CPU; the twin of ``__graft_entry__.entry()``; and
the host syncs of a steady scan batch. The kernels have no CPU mode, so
these tests are marked ``cuda`` and skip where torch.cuda.is_available() is
false.

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
    launches = nms_cuda.KERNEL.launches
    got = nms_padded_batched(boxes.to(cuda), scores.to(cuda), ldm.to(cuda), **kw)
    one = nms_padded(boxes[0].to(cuda), scores[0].to(cuda), ldm[0].to(cuda), **kw)
    assert nms_cuda.KERNEL.launches == launches + 2
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
        declared = (nms_cuda.KERNEL, align_cuda.KERNEL, detection_cuda.KERNEL)
        counts = tuple(k.launches for k in declared)
        with torch.no_grad():
            out = build_pipeline(device=dev, **kw)(
                params, torch.from_numpy(frames).to(dev), torch.from_numpy(gallery).to(dev),
                torch.ones(8, dtype=torch.bool, device=dev), priors)
        if dev != "cpu":
            assert tuple(k.launches for k in declared) == (counts[0] + 1, counts[1] + 1, counts[2])
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
@pytest.mark.parametrize("with_spoof,with_quality,spoof_size", [
    (False, True, 112), (True, False, 112), (True, True, 64), (True, True, 224)])
def test_build_pipeline_switches_on_the_card_match_cpu(cuda, with_spoof, with_quality, spoof_size):
    """Spoof off, quality off and other spoof crop sizes at det 128, f32
    (TF32 off): card against CPU, the outputs switched off absent on both."""
    kw = dict(det_size=128, max_faces=4, pre_nms_topk=64, conf_thresh=0.3, compute_dtype="float32",
              with_spoof=with_spoof, with_quality=with_quality, spoof_size=spoof_size)
    cfg = load_config(det_size=128, max_faces_per_frame=4, pre_nms_topk=64,
                      det_conf_threshold=0.3, compute_dtype="float32")
    frames = np.stack([make_scene(128, np.random.default_rng(s), max_faces=1, portrait=True)[0]
                       for s in (3, 5, 8)])
    gallery = np.random.default_rng(0).normal(size=(8, 128)).astype(np.float32)
    outs = []
    for dev in ("cpu", cuda):
        eng = RecognitionEngine(cfg, device=dev)
        with torch.no_grad():
            out = build_pipeline(device=dev, **kw)(
                eng.params, torch.from_numpy(frames).to(dev), torch.from_numpy(gallery).to(dev),
                torch.ones(8, dtype=torch.bool, device=dev), eng._priors)
        outs.append({k: v.cpu().numpy() for k, v in out.items()})
    want, got = outs
    assert set(got) == set(want)
    assert ("fake_prob" in got) == with_spoof and ("quality" in got) == with_quality
    assert want["count"].sum() >= 3
    for key in ("valid", "count", "best_idx", "is_match"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    v = want["valid"]
    for key, atol in (("boxes", 1e-2), ("embeddings", 1e-3), ("fake_prob", 1e-3),
                      ("quality", 1e-3), ("best_distance", 1e-3)):
        if key in want:
            np.testing.assert_allclose(got[key][v], want[key][v], rtol=0, atol=atol, err_msg=key)


@pytest.mark.cuda
def test_engine_without_spoof_on_the_card_matches_cpu(cuda):
    """RecognitionEngine(with_spoof=False) at det 128, f32 (TF32 off): the
    packed results on the card against the CPU, the fake_prob column zeros,
    encode_image's fake_prob None."""
    cfg = load_config(det_size=128, max_faces_per_frame=4, pre_nms_topk=64,
                      det_conf_threshold=0.3, compute_dtype="float32")
    frames = np.stack([make_scene(128, np.random.default_rng(s), max_faces=1, portrait=True)[0]
                       for s in (3, 5, 8)])
    engs = [RecognitionEngine(cfg, device=d, with_spoof=False) for d in ("cpu", cuda)]
    want, got = (e.fetch(e.submit(frames)) for e in engs)
    assert want["count"].sum() >= 3 and not got["fake_prob"].any()
    for key in ("valid", "count", "best_idx", "is_match"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    v = want["valid"]
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], rtol=0, atol=1e-2)
    faces = engs[1].encode_image(frames[0])
    assert faces and all(f["fake_prob"] is None for f in faces)


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


# --- the chains' one-pass kernel (csrc/bn_act.cu): iresnet's and RetinaFace's --------

# iresnet50's activations after its convs: (C, H = W)
R50_SHAPES = [(64, 112), (64, 56), (128, 56), (128, 28), (256, 28), (256, 14), (512, 14), (512, 7)]
BN_ACT_MODES = ("stem", "prelu", "prelu_pad", "leaky", "leaky_pad", "add", "add_last", "down",
                "down_last")
# RetinaFace's activations after its activated convs at det 640: (C, H = W)
DET_SHAPES = [(8, 320), (16, 320), (16, 160), (32, 160), (32, 80), (64, 80), (64, 40), (128, 40),
              (128, 20), (256, 20), (16, 80), (16, 40), (16, 20)]
DET_MODES = ("leaky", "leaky_pad", "prelu", "prelu_pad")


def _bn_dict(rng, c, dev):
    return {"gamma": torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)).to(dev),
            "beta": torch.from_numpy(rng.normal(0, 0.3, c).astype(np.float32)).to(dev),
            "mean": torch.from_numpy(rng.normal(0, 0.3, c).astype(np.float32)).to(dev),
            "var": torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)).to(dev)}


def _bn_act_call(mode, x, sc, p):
    """The mode through the wrapper: (r or y, u), None where not written."""
    from frp_tpu_torch.ops import bn_act_cuda

    if mode.startswith("leaky"):
        return bn_act_cuda.bn_leaky(x, p["bn"], pad=(1, 1) if mode == "leaky_pad" else None), None
    if mode in ("stem", "prelu", "prelu_pad"):
        got = bn_act_cuda.bn_prelu(x, p["bn"], p["act"],
                                   bn_next=p["bn_next"] if mode == "stem" else None,
                                   pad=(1, 1) if mode == "prelu_pad" else None)
        return got if mode == "stem" else (got, None)
    return bn_act_cuda.bn_add(x, p["bn"], sc, p["bn_next"],
                              down_bn=p["down_bn"] if mode.startswith("down") else None,
                              keep=not mode.endswith("_last"))


def _bn_act_f32(mode, x, sc, p):
    """The twin's chain computed in f32 from the same folds (rounded to x's
    dtype, as the kernel reads them), unrounded: (r or y, u)."""
    from frp_tpu_torch.models import nn

    def fold(bn):
        s, t = nn.bn_fold(bn, x)
        return s.float(), t.float()

    s, t = fold(p["bn"])
    v = x.float() * s + t
    if mode in ("stem", "prelu", "prelu_pad", "leaky", "leaky_pad"):
        a = (0.1 if mode.startswith("leaky")
             else nn._cast(p["act"], "alpha", x.dtype).float()[:, None, None])
        v = torch.where(v >= 0, v, a * v)
        if mode.endswith("_pad"):
            return torch.nn.functional.pad(v, (0, 1, 0, 1)), None
    else:
        d = sc.float()
        if mode.startswith("down"):
            sd, td = fold(p["down_bn"])
            d = d * sd + td
        v = d + v
    u = None
    if mode not in ("prelu", "prelu_pad", "leaky", "leaky_pad"):
        s1, t1 = fold(p["bn_next"])
        u = v * s1 + t1
    return (None if mode.endswith("_last") else v), u


def _ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """The most units in the last place between two tensors of one 16-bit
    float type (the bit patterns mapped to a monotone integer scale)."""
    def ordered(t):
        b = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(b < 0, -(b & 0x7FFF), b)

    return int((ordered(got) - ordered(want)).abs().max()) if got.numel() else 0


@pytest.mark.cuda
@pytest.mark.parametrize("c,h", R50_SHAPES)
def test_bn_act_kernel_matches_its_twin_in_f32_rounded_once(cuda, c, h):
    """Every mode at each of iresnet50's activation shapes, B = 64, bf16:
    within 1 bf16 ulp of the plain chain computed in f32 and rounded once
    (identity and down shortcuts, the padded output's zero border
    included); at f32, equal to the f32 chain. Channels-last outputs of the
    input's shape (one row and column more when padded)."""
    from frp_tpu_torch.ops import bn_act_cuda

    rng = np.random.default_rng(c * 1000 + h)
    layers = {"bn": _bn_dict(rng, c, cuda), "down_bn": _bn_dict(rng, c, cuda),
              "bn_next": _bn_dict(rng, c, cuda),
              "act": {"alpha": torch.from_numpy(rng.uniform(0.05, 0.45, c).astype(np.float32)).to(cuda)}}
    act = torch.from_numpy(rng.normal(0, 1.5, (2, 64, h, h, c)).astype(np.float32)).to(cuda)
    for dtype in (torch.bfloat16, torch.float32):
        x, sc = (a.to(dtype).permute(0, 3, 1, 2) for a in act)
        for mode in BN_ACT_MODES:
            before = bn_act_cuda.KERNEL.launches
            got = _bn_act_call(mode, x, sc, layers)
            torch.cuda.synchronize()
            assert bn_act_cuda.KERNEL.launches == before + 1
            for g, w in zip(got, _bn_act_f32(mode, x, sc, layers)):
                assert (g is None) == (w is None), mode
                if w is None:
                    continue
                assert g.dtype == dtype and g.shape == w.shape, mode
                assert g.is_contiguous(memory_format=torch.channels_last), mode
                if dtype == torch.float32:
                    assert torch.equal(g, w), (mode, float((g - w).abs().max()))
                else:
                    assert _ulps(g, w.to(dtype)) <= 1, (mode, _ulps(g, w.to(dtype)))
            if mode.endswith("_pad"):
                assert not got[0][:, :, h].any() and not got[0][..., h].any()


@pytest.mark.cuda
@pytest.mark.parametrize("c,h", DET_SHAPES)
def test_bn_act_detector_modes_are_exact(cuda, c, h):
    """RetinaFace's modes (BN with leaky ReLU at 0.1 or PReLU, each also
    into a stride-2 conv's padded input) at each of the detector's
    activation shapes at det 640, 8 frames: in bf16 0 ulps from the chain
    computed in f32 and rounded once; in f32 equal to the eager chain (the
    plain twins, run on the card) bit for bit; the padded border zero."""
    from frp_tpu_torch.ops import bn_act_cuda

    rng = np.random.default_rng(c * 1000 + h + 7)
    layers = {"bn": _bn_dict(rng, c, cuda),
              "act": {"alpha": torch.from_numpy(rng.uniform(0.05, 0.45, c).astype(np.float32)).to(cuda)}}
    act = torch.from_numpy(rng.normal(0, 1.5, (8, h, h, c)).astype(np.float32)).to(cuda)
    for dtype in (torch.bfloat16, torch.float32):
        x = act.to(dtype).permute(0, 3, 1, 2)
        for mode in DET_MODES:
            pad = (1, 1) if mode.endswith("_pad") else None
            before = bn_act_cuda.KERNEL.launches
            got, _ = _bn_act_call(mode, x, None, layers)
            torch.cuda.synchronize()
            assert bn_act_cuda.KERNEL.launches == before + 1
            if dtype == torch.float32:
                want = (bn_act_cuda.bn_leaky_plain(x, layers["bn"], 0.1, pad) if mode.startswith("leaky")
                        else bn_act_cuda.bn_prelu_plain(x, layers["bn"], layers["act"], pad=pad))
                assert torch.equal(got, want), (mode, float((got - want).abs().max()))
            else:
                want = _bn_act_f32(mode, x, None, layers)[0].to(dtype)
                assert _ulps(got, want) == 0, (mode, _ulps(got, want))
            assert got.dtype == dtype and got.shape == want.shape, mode
            assert got.is_contiguous(memory_format=torch.channels_last), mode
            if pad is not None:
                assert not got[:, :, h].any() and not got[..., h].any()


@pytest.mark.cuda
def test_bn_act_refuses_what_it_cannot_take_on_the_card(cuda):
    """A CUDA activation that is not channels-last, of float16 or float64,
    a shortcut of another shape, or a bf16 vector of slopes standing in for
    the leaky slope raises before any launch; nothing falls back to the
    twin."""
    from frp_tpu_torch.ops import bn_act_cuda

    rng = np.random.default_rng(0)
    bn = _bn_dict(rng, 64, cuda)
    act = {"alpha": torch.full((64,), 0.25, device=cuda)}
    x = torch.randn(2, 64, 8, 8, device=cuda, dtype=torch.bfloat16)
    before = bn_act_cuda.KERNEL.launches
    with pytest.raises(ValueError, match="channels-last"):
        bn_act_cuda.bn_prelu(x, bn, act)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="f32 or bf16"):
            bn_act_cuda.bn_prelu(x.to(dtype).contiguous(memory_format=torch.channels_last), bn, act)
    with pytest.raises(ValueError, match="shortcut"):
        x = x.contiguous(memory_format=torch.channels_last)
        bn_act_cuda.bn_add(x, bn, x[:1], bn)
    with pytest.raises(ValueError, match="slope"):
        bn_act_cuda.bn_leaky(x, bn, torch.full((64,), 0.1, device=cuda, dtype=torch.bfloat16))
    assert bn_act_cuda.KERNEL.launches == before


def _faces(n: int) -> torch.Tensor:
    x = np.stack([make_scene(112, np.random.default_rng(40 + i), max_faces=1, portrait=True)[0]
                  for i in range(n)]).astype(np.float32)
    return torch.from_numpy((x - 127.5) / 128.0)


@pytest.mark.cuda
def test_iresnet50_forward_through_the_kernel_matches_the_unfused_forward(cuda):
    """A seeded iresnet50-512 with fitted-looking BN stats on 16 rendered
    faces: the inference forward (no grad) launches the kernel 1 + 2 x 24 =
    49 times and, at bf16, its embeddings are at cosine >= 0.9999 of the
    unfused forward's (the block forward, taken when the input requires
    grad, which launches none); at f32 within 1e-5."""
    from frp_tpu_torch.models.iresnet import init_iresnet
    from frp_tpu_torch.ops import bn_act_cuda
    from frp_tpu_torch.testing.onnx_export import realistic_stats

    tree = realistic_stats(init_iresnet(5, variant="iresnet50", embed_dim=512), np.random.default_rng(6))
    params = convert_params(tree, cuda)
    x = _faces(16).to(cuda)
    for dtype in (torch.bfloat16, torch.float32):
        xd = x.to(dtype)
        before = bn_act_cuda.KERNEL.launches
        with torch.no_grad():
            got = iresnet_forward(params, xd)
        assert bn_act_cuda.KERNEL.launches == before + 49
        want = iresnet_forward(params, xd.clone().requires_grad_(True)).detach()
        assert bn_act_cuda.KERNEL.launches == before + 49
        got, want = got.cpu().numpy(), want.cpu().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        else:
            cos = np.sum(got * want, 1) / np.linalg.norm(got, axis=1) / np.linalg.norm(want, axis=1)
            assert cos.min() >= 0.9999, cos


@pytest.mark.cuda
def test_bn_act_launches_once_for_the_stem_and_twice_a_block(cuda):
    """Launches a forward: iresnet18 17 (8 blocks), iresnet50 49 (24
    blocks), at any batch; a training forward (batch statistics) none."""
    from frp_tpu_torch.models.iresnet import init_iresnet
    from frp_tpu_torch.ops import bn_act_cuda

    x = _faces(3).to(cuda)
    for variant, want in (("iresnet18", 17), ("iresnet50", 49)):
        params = convert_params(init_iresnet(0, variant=variant, embed_dim=128), cuda)
        for b in (1, 3):
            before = bn_act_cuda.KERNEL.launches
            with torch.no_grad():
                iresnet_forward(params, x[:b])
            assert bn_act_cuda.KERNEL.launches - before == want, (variant, b)
        before = bn_act_cuda.KERNEL.launches
        iresnet_forward(params, x, train=True)
        assert bn_act_cuda.KERNEL.launches == before


def _detector(act: str, dev) -> dict:
    """The shipped detector (leaky ReLU) or a seeded one with learned slopes
    and fitted-looking BN stats (PReLU, as a real det export imports)."""
    from frp_tpu_torch.engine.pipeline import load_any
    from frp_tpu_torch.models.retinaface import init_retinaface
    from frp_tpu_torch.testing.onnx_export import realistic_stats

    if act == "leaky":
        tree = load_any(os.path.join(REPO, "weights", "retinaface_synthetic.npz"), init_retinaface(0))
    else:
        tree = realistic_stats(init_retinaface(3, act="prelu"), np.random.default_rng(4),
                               gamma=(0.5, 1.5))
    return convert_params(tree, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("padding", ["same", "torch"])
@pytest.mark.parametrize("act", ["leaky", "prelu"])
def test_retinaface_forward_through_the_pass_equals_the_eager_forward_in_f32(cuda, act, padding):
    """Two rendered 640 frames, f32 (TF32 off): the inference forward
    launches the pass 38 times (one an activated conv) and its outputs equal
    the eager forward's bit for bit (taken when the input requires grad,
    which launches none), with leaky ReLU and with PReLU, in both padding
    modes (the stride-2 depthwise convs' padded inputs written by the pass
    under "same")."""
    from frp_tpu_torch.models import nn
    from frp_tpu_torch.models.retinaface import retinaface_forward
    from frp_tpu_torch.ops import bn_act_cuda

    params = _detector(act, cuda)
    frames = np.stack([make_scene(640, np.random.default_rng(50 + i), max_faces=3)[0]
                       for i in range(2)]).astype(np.float32)
    x = torch.from_numpy((frames - 127.5) / 128.0).to(cuda)
    nn.set_padding_mode(padding)
    try:
        before = bn_act_cuda.KERNEL.launches
        with torch.no_grad():
            got = retinaface_forward(params, x)
        assert bn_act_cuda.KERNEL.launches == before + 38
        want = retinaface_forward(params, x.clone().requires_grad_(True))
        assert bn_act_cuda.KERNEL.launches == before + 38
    finally:
        nn.set_padding_mode("same")
    for k in ("loc", "ldm", "score", "cls_logits"):
        assert torch.equal(got[k], want[k].detach()), (k, float((got[k] - want[k]).abs().max()))


@pytest.mark.cuda
def test_retinaface_bf16_forward_through_the_pass_finds_the_eager_forwards_faces(cuda):
    """Two ticks of the bench's stream (8 1080p cameras of rendered faces),
    letterboxed to 640, through the shipped detector in bf16 and the fused
    detection head: valid and count of the forward through the pass equal
    the eager forward's."""
    from frp_tpu_torch.bench import Scene
    from frp_tpu_torch.engine.batching import letterbox
    from frp_tpu_torch.models.retinaface import retinaface_forward

    params = _detector("leaky", cuda)
    scene = Scene(np.random.default_rng(11))
    frames = []
    for _ in range(2):
        scene.advance()
        frames += [letterbox(cam, 640, to_rgb=True)[0] for cam in scene.cams]
    x = ((torch.from_numpy(np.stack(frames)).to(cuda).float() - 127.5) / 128.0).to(torch.bfloat16)
    priors = torch.from_numpy(generate_anchors(640).copy()).to(cuda)

    def head(det):
        with torch.no_grad():
            return detection_cuda.fused_detection_head(
                det["loc"].detach(), det["ldm"].detach(), det["score"].detach(), priors,
                image_size=640.0, pre_topk=256, max_out=16)

    with torch.no_grad():
        got = head(retinaface_forward(params, x))
    want = head(retinaface_forward(params, x.clone().requires_grad_(True)))
    assert int(want["count"].sum()) > 0
    assert torch.equal(got["count"], want["count"]), (got["count"], want["count"])
    assert torch.equal(got["valid"], want["valid"])


# --- the ViT's residual add and LayerNorm in one pass (csrc/add_ln.cu) ----------

ADD_LN_SITES = ("pos_embed", "proj", "fc2", "last")
# f32 against PyTorch's own LayerNorm: |LN(r)| up to about 6 times the
# relative error another order of the sums leaves in the statistics, about
# 2**-20 at 768 elements, with a margin of 3
ADD_LN_F32_ATOL = 3 * 6 * 2.0 ** -20


def _add_ln_case(site, k, t, w, dtype, dev, seed=0):
    """x, d and the LN dict (float32 gamma and beta) of one site: d the
    pos_embed [T, W] at site 1, [K, T, W] otherwise."""
    rng = np.random.default_rng(seed + w + k)
    x = torch.from_numpy(rng.normal(0, 1.0, (k, t, w)).astype(np.float32)).to(dev, dtype)
    shape = (t, w) if site == "pos_embed" else (k, t, w)
    d = torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32)).to(dev, dtype)
    ln = {"gamma": torch.from_numpy(rng.uniform(0.8, 1.2, w).astype(np.float32)).to(dev),
          "beta": torch.from_numpy(rng.normal(0, 0.2, w).astype(np.float32)).to(dev)}
    return x, d, ln


@pytest.mark.cuda
@pytest.mark.parametrize("k,t", [(64, 144), (3, 7)])
@pytest.mark.parametrize("w", [96, 768])
def test_add_ln_kernel_matches_its_twin_in_f32_rounded_once(cuda, w, k, t):
    """Every site kind at the test ViT's width and ViT-L's, over a whole
    number of warps' rows and a ragged one: r equal to x + d rounded once;
    LN(r) within 1 bf16 ulp of ``add_ln_f32`` (the kernel's arithmetic in
    f32, rounded once), and equal to it in f32, where it is also within
    ``ADD_LN_F32_ATOL`` of PyTorch's LayerNorm of r; one launch each,
    outputs of x's shape and dtype, r left out at the last site."""
    from frp_tpu_torch.ops import add_ln_cuda

    for dtype in (torch.bfloat16, torch.float32):
        for site in ADD_LN_SITES:
            last = site == "last"
            x, d, ln = _add_ln_case(site, k, t, w, dtype, cuda)
            before = add_ln_cuda.KERNEL.launches
            r, u = add_ln_cuda.add_ln(x, d, ln, 1e-5, last=last)
            torch.cuda.synchronize()
            assert add_ln_cuda.KERNEL.launches == before + 1
            want_r, want_u = add_ln_cuda.add_ln_f32(x, d, ln, 1e-5, last=last)
            assert (r is None) == last, site
            if not last:
                assert r.dtype == dtype and torch.equal(r, want_r), site
            assert u.dtype == dtype and u.shape == x.shape and u.is_contiguous(), site
            if dtype == torch.float32:
                assert torch.equal(u, want_u), (site, float((u - want_u).abs().max()))
                lib = torch.nn.functional.layer_norm(x + d, (w,), ln["gamma"], ln["beta"], 1e-5)
                assert float((u - lib).abs().max()) <= ADD_LN_F32_ATOL, site
            else:
                assert _ulps(u, want_u) <= 1, (site, _ulps(u, want_u))


@pytest.mark.cuda
def test_add_ln_refuses_what_it_cannot_take_on_the_card(cuda):
    """A CUDA input of float16, not contiguous, off a 16-byte boundary, a d
    of another shape, or a width the kernel has no instance for raises
    before any launch; nothing falls back to the twin."""
    from frp_tpu_torch.ops import add_ln_cuda

    x, d, ln = _add_ln_case("proj", 2, 8, 96, torch.bfloat16, cuda)
    before = add_ln_cuda.KERNEL.launches
    with pytest.raises(ValueError, match="f32 or bf16"):
        add_ln_cuda.add_ln(x.half(), d.half(), ln, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        add_ln_cuda.add_ln(x.transpose(0, 1), d, ln, 1e-5)
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(x.numel() + 1, device=cuda, dtype=x.dtype)
        add_ln_cuda.add_ln(flat[1:].view(x.shape), d, ln, 1e-5)
    with pytest.raises(ValueError, match="trailing axes"):
        add_ln_cuda.add_ln(x, d[:1], ln, 1e-5)
    xw, dw, lw = _add_ln_case("proj", 2, 8, 1032, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="width 1032"):
        add_ln_cuda.add_ln(xw, dw, lw, 1e-5)
    assert add_ln_cuda.KERNEL.launches == before


def _vit_weights(seed: int, sizes: dict, dim: int) -> dict:
    """tests/test_torch_vit.py's ``_weights``, copied: a seeded ViT tree with
    larger biases, LN gammas and BN variances U(0.8, 1.2), fc1 at three
    times its He scale. That file imports ``tests.vit_reference``, which a
    machine with another top-level ``tests`` package on its path cannot
    resolve, so this file loads the reference by its path."""
    from frp_tpu_torch.models import vit
    from frp_tpu_torch.models.params import _unflatten, flatten_params

    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flatten_params(vit.init_vit(rng, embed_dim=dim, **sizes)).items():
        last = k.rsplit("/", 1)[-1]
        if last in ("gamma", "var"):
            v = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        elif last in ("beta", "b", "mean", "pos_embed"):
            v = rng.normal(0.0, 0.2, v.shape).astype(np.float32)
        elif k.startswith("blocks/") and k.endswith("fc1/w"):
            v = v * 3.0
        out[k] = v
    return _unflatten(out)


def _vit_tol(depth: int) -> float:
    """tests/test_torch_vit.py's BF16_TOL at any depth: twice the RMS of
    8 + 9 x depth independent bf16 roundings (26 at depth 2)."""
    return 2 * np.sqrt((8 + 9 * depth) / 3) * 2.0 ** -8


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["small", "vit_l"])
def test_vit_forward_through_the_pass_matches_the_reference(cuda, variant):
    """The ViT forward on the card, the test ViT (width 96, depth 2) and
    ViT-L at its published widths (768, depth 24), on weights and crops
    drawn as tests/test_torch_vit.py draws them: the pass launches 2 x
    depth + 1 times a forward (49 for ViT-L), and the embeddings are within
    the derived bf16 tolerance of the float32 reference
    ``tests/vit_reference.py`` (run on the card, TF32 off); at f32 the test
    ViT within test_torch_vit's 1e-5."""
    from frp_tpu_torch.models import vit
    from frp_tpu_torch.models.params import _unflatten, flatten_params
    from frp_tpu_torch.ops import add_ln_cuda
    from frp_tpu_torch.ops.image import normalize_face

    spec = importlib.util.spec_from_file_location(
        "vit_reference", os.path.join(REPO, "tests", "vit_reference.py"))
    vit_reference = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vit_reference)
    small = dict(width=96, depth=2, heads=2, mlp=384, patch=9)
    sizes, dim, n = (small, 64, 8) if variant == "small" else (vit.VIT_VARIANTS["vit_l"], 512, 16)
    tree = _vit_weights(7, sizes, dim)
    dev_tree = _unflatten({k: torch.from_numpy(v).to(cuda)
                           for k, v in flatten_params(tree).items()})
    g = torch.Generator().manual_seed(7)
    x = normalize_face(torch.rand(n, 112, 112, 3, generator=g) * 255.0).to(cuda)
    want = vit_reference.forward(dev_tree, x, heads=sizes["heads"])
    params = convert_params(tree, cuda)
    dtypes = (torch.bfloat16, torch.float32) if variant == "small" else (torch.bfloat16,)
    for dtype in dtypes:
        before = add_ln_cuda.KERNEL.launches
        with torch.no_grad():
            got = vit.vit_forward(params, x.to(dtype), heads=sizes["heads"])
        assert add_ln_cuda.KERNEL.launches == before + 2 * sizes["depth"] + 1
        dist = float((got - want).norm(dim=1).max())
        tol = _vit_tol(sizes["depth"]) if dtype == torch.bfloat16 else 1e-5
        assert got.dtype == torch.float32 and dist <= tol, (dtype, dist, tol)


# --- the Swin-T embedder (models/swin.py) and add_ln at its widths -----------

# the Swin's residual streams [K x grid^2, C] at 8 faces: stages 1-4
SWIN_ROWS = [(8 * 3136, 96), (8 * 784, 192), (8 * 196, 384), (8 * 49, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,w", SWIN_ROWS)
def test_add_ln_at_the_swins_widths_equals_its_twin(cuda, rows, w):
    """The pass at the Swin's four widths (96, 192 and 384 leave lanes of
    the row's warp idle: 12, 24 and 48 vectors a bf16 row), each residual
    site the Swin runs: r and LN(r) equal to ``add_ln_f32`` in bf16 and
    f32 (0 ulps), and the last site's float32 LN at 768."""
    from frp_tpu_torch.ops import add_ln_cuda

    for dtype in (torch.bfloat16, torch.float32):
        for site in ("proj", "last") if w == 768 else ("proj",):
            last = site == "last"
            x, d, ln = _add_ln_case(site, 1, rows, w, dtype, cuda)
            before = add_ln_cuda.KERNEL.launches
            r, u = add_ln_cuda.add_ln(x, d, ln, 1e-5, last=last)
            torch.cuda.synchronize()
            assert add_ln_cuda.KERNEL.launches == before + 1
            want_r, want_u = add_ln_cuda.add_ln_f32(x, d, ln, 1e-5, last=last)
            if not last:
                assert torch.equal(r, want_r), (site, dtype)
            assert u.dtype == dtype and torch.equal(u, want_u), (site, dtype)


def _swin_weights(seed: int, sizes: dict, dim: int) -> dict:
    """tests/test_torch_swin.py's ``_weights``, copied (that file imports
    ``tests.swin_reference``; this one loads the reference by its path):
    larger biases, LN gammas and BN variances U(0.8, 1.2), the
    relative-position tables N(0, 2), the last stage's qkv weights at twice
    their He scale."""
    from frp_tpu_torch.models import swin
    from frp_tpu_torch.models.params import _unflatten, flatten_params

    rng = np.random.default_rng(seed)
    out = {}
    last_stage = f"stages/{len(sizes['depths']) - 1}/"
    for k, v in flatten_params(swin.init_swin(rng, embed_dim=dim, **sizes)).items():
        last = k.rsplit("/", 1)[-1]
        if last in ("gamma", "var"):
            v = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        elif last in ("beta", "b", "mean"):
            v = rng.normal(0.0, 0.2, v.shape).astype(np.float32)
        elif last == "rel_bias":
            v = rng.normal(0.0, 2.0, v.shape).astype(np.float32)
        elif k.startswith(last_stage) and k.endswith("qkv/w"):
            v = v * 2.0
        out[k] = v
    return _unflatten(out)


def _swin_crops(seed: int, n: int) -> torch.Tensor:
    """tests/test_torch_swin.py's ``_crops``: a smooth field plus noise."""
    from frp_tpu_torch.ops.image import normalize_face

    g = torch.Generator().manual_seed(seed)
    field = torch.nn.functional.interpolate(torch.rand(n, 3, 7, 7, generator=g), size=(112, 112),
                                            mode="bilinear", align_corners=False)
    field = field.permute(0, 2, 3, 1)
    return normalize_face((0.9 * field + 0.1 * torch.rand(n, 112, 112, 3, generator=g)) * 255.0)


def _swin_tol(blocks: int, merges: int) -> float:
    """tests/test_torch_swin.py's BF16_TOL at any depth: twice the RMS of
    7 + 11 x blocks + 2 x merges independent bf16 roundings (101 at the
    test's 8 blocks, 145 for Swin-T)."""
    return 2 * np.sqrt((7 + 11 * blocks + 2 * merges) / 3) * 2.0 ** -8


def _kernels_in(prof, span: str) -> list:
    """The names of the device kernels and copies launched inside each host
    span ``span`` of a profile, each op id's once."""
    names, seen = [], set()
    for top in (e for e in prof.events() if e.name == span):
        todo = [top]
        while todo:
            e = todo.pop()
            if e.kernels and e.id not in seen:
                seen.add(e.id)
                names += [k.name for k in e.kernels]
            todo.extend(e.cpu_children)
    return names


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["small", "swin_t"])
def test_swin_forward_on_the_card_matches_the_reference(cuda, variant):
    """The Swin forward on the card, the test Swin (width 16) and Swin-T at
    its published widths, on weights and crops drawn as
    tests/test_torch_swin.py draws them: add_ln launches 2 x blocks - 3 times
    a forward (21 for Swin-T: a stage's last add before merging is plain),
    and the bf16 embeddings are within the derived tolerance of the float32
    reference ``tests/swin_reference.py`` (on the card, TF32 off); the test
    Swin at f32 within 1e-5. Inside ``frp.swin.sdpa`` the card runs the
    fused attention kernels alone: no copy, pad or fill of a bias."""
    from frp_tpu_torch.models import swin
    from frp_tpu_torch.models.params import _unflatten, flatten_params
    from frp_tpu_torch.ops import add_ln_cuda

    spec = importlib.util.spec_from_file_location(
        "swin_reference", os.path.join(REPO, "tests", "swin_reference.py"))
    swin_reference = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(swin_reference)
    small = dict(width=16, depths=(2, 2, 2, 2), heads=(1, 2, 4, 8))
    sizes, dim, n = ((small, 64, 8) if variant == "small"
                     else (swin.SWIN_VARIANTS["swin_t"], 512, 16))
    tree = _swin_weights(7, sizes, dim)
    dev_tree = _unflatten({k: torch.from_numpy(v).to(cuda)
                           for k, v in flatten_params(tree).items()})
    x = _swin_crops(7, n).to(cuda)
    want = swin_reference.forward(dev_tree, x)
    params = convert_params(tree, cuda)
    blocks = sum(sizes["depths"])
    dtypes = (torch.bfloat16, torch.float32) if variant == "small" else (torch.bfloat16,)
    for dtype in dtypes:
        before = add_ln_cuda.KERNEL.launches
        with torch.no_grad():
            got = swin.swin_forward(params, x.to(dtype))
        assert add_ln_cuda.KERNEL.launches == before + 2 * blocks - 3
        dist = float((got - want).norm(dim=1).max())
        tol = _swin_tol(blocks, 3) if dtype == torch.bfloat16 else 1e-5
        assert got.dtype == torch.float32 and dist <= tol, (dtype, dist, tol)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        swin.swin_forward(params, x.to(torch.bfloat16))
        torch.cuda.synchronize()
    names = _kernels_in(prof, "frp.swin.sdpa")
    # one call a run of windows: four in a shifted block, one in another
    runs = sum(4 if swin.shift_of(56 >> s, i, 7) else 1
               for s, depth in enumerate(sizes["depths"]) for i in range(depth))
    assert len(names) == runs, names
    odd = [k for k in names if not any(s in k.lower() for s in ("fmha", "attention", "cudnn"))]
    assert not odd, odd


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
    on.process_frames(scenes)  # the rung pick reads counts of earlier batches
    want, got = off.process_frames(scenes), on.process_frames(scenes)
    assert on.embed_stats["speculated"] == 1
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

    def scans(stop=None, fetched=None):
        """All ticks once; with ``stop``, on until it is set and 2 scans are
        done, setting ``fetched`` at each fetch."""
        enc = DeltaEncoder(block_bytes=128)
        outs = []
        while not ((stop.is_set() and len(outs) >= 2) if stop else len(outs) == len(ticks)):
            outs.append(eng.fetch(eng.submit_encoded(enc.encode(ticks[len(outs) % len(ticks)]))))
            if fetched is not None:
                fetched.set()
        return outs

    alone, scans_alone = svc.process_video(path), scans()
    eng.delta_stats.update(keyframes=0, deltas=0, desyncs=0)
    stop, fetched, outs = threading.Event(), threading.Event(), []
    th = threading.Thread(target=lambda: outs.extend(scans(stop, fetched)))
    th.start()
    try:
        # the video starts once the scan has fetched, so the two overlap
        assert fetched.wait(120), "the scan thread fetched no batch"
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


# --- the mesh --------------------------------------------------------------------

@pytest.mark.cuda
def test_engine_over_a_mesh_on_the_card_equals_unsharded(cuda):
    """chip_smoke.py phase 14 (a) at 2 ticks: the default engine over a mesh
    of the card repeated twice launches kernels 1 and 2 once a shard a
    batch and equals the unsharded engine (bf16 by the NEAR_TIE rule; f32
    bit for bit in valid, count and best_idx, boxes within 1e-2 px)."""
    smoke = _smoke()
    me = smoke.run_mesh_engine(cuda, smoke.render_scenes(smoke.FRAMES, 640, smoke.SEED), 2, 1)
    assert me["stream_launches"] == {"detection_head": 6, "warp_crops": 6, "greedy_nms": 0}
    assert me["bf16"]["ok"] and me["bf16"]["slots"] > 0
    assert me["f32_faces"] > 0 and me["f32_max_abs_err"]["boxes"] <= 1e-2


@pytest.mark.cuda
def test_one_nccl_rank_step_equals_one_process_step(cuda):
    """chip_smoke.py phase 14 (c): a one-rank NCCL group (a 1 x 1 process
    mesh, which takes no collective in its step) runs the f32 ArcFace step
    and equals the one-process step within train_parity's bounds."""
    errs = _smoke().run_nccl_rank(cuda)["held"]["arcface_mobilefacenet"]
    assert errs["loss_rel"] <= 1e-4 and errs["params"] <= 1e-4


# --- the entry and the host's syncs ----------------------------------------------

@pytest.mark.cuda
def test_entry_on_the_card(cuda):
    """The twin of __graft_entry__.entry() on the card: one call launches the
    warp and the greedy kernel (K=128) once each and gives the 14 results,
    finite, at the reference's shapes; at f32 its valid and count equal the
    CPU's bit for bit and its boxes are within 1e-2 px."""
    from frp_tpu_torch.testing.entry import entry

    fn, args = entry()
    warps, greedy = align_cuda.KERNEL.launches, nms_cuda.KERNEL.launches
    with torch.no_grad():
        out = fn(*args)
    torch.cuda.synchronize()
    assert (align_cuda.KERNEL.launches - warps, nms_cuda.KERNEL.launches - greedy) == (1, 1)
    assert len(out) == 14 and out["embeddings"].shape == (2, 8, 128)
    assert out["topk_idx"].shape == (2, 8, 5) and out["count"].min() > 0
    for key, v in out.items():
        if v.is_floating_point():
            assert torch.isfinite(v[out["valid"]]).all(), key
    (fn, args), (cfn, cargs) = entry(compute_dtype="float32"), entry("cpu", "float32")
    with torch.no_grad():
        got, want = fn(*args), cfn(*cargs)
    for key in ("valid", "count"):
        np.testing.assert_array_equal(got[key].cpu().numpy(), want[key].numpy(), err_msg=key)
    np.testing.assert_allclose(got["boxes"].cpu().numpy(), want["boxes"].numpy(), rtol=0, atol=1e-2)


@pytest.mark.cuda
def test_steady_submit_makes_no_host_sync(cuda):
    """The default engine's delta scan (128 slots: compaction on), counted by
    chip_smoke.py's host_syncs on a steady batch: submit_encoded waits for
    the card 0 times, its fetch at most once (the result's copy)."""
    smoke = _smoke()
    scenes = smoke.render_scenes(8, 640, 0)
    eng = RecognitionEngine(load_config(**smoke.PROFILE), device=cuda)
    enc = DeltaEncoder(block_bytes=128)
    for t in range(4):
        eng.fetch(eng.submit_encoded(enc.encode(smoke.tick_batch(scenes, t))))
    payload, handle = enc.encode(smoke.tick_batch(scenes, 4)), {}
    assert smoke.host_syncs(lambda: handle.update(h=eng.submit_encoded(payload))) == 0
    assert smoke.host_syncs(lambda: eng.fetch(handle["h"])) <= 1
    assert eng.embed_stats["speculated"] == 4 and eng.embed_stats["redone"] == 0
