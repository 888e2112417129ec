"""PyTorch port, on the card: each hand-written CUDA kernel against its plain
PyTorch version at the main path's shapes (masks, valid flags and counts bit
for bit, floats within 1e-3). The kernels have no CPU mode, so these tests
are marked ``cuda`` and skip where torch.cuda.is_available() is false.

The card machine has no JAX and tests/conftest.py imports it, so run them
there with:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from frp_tpu_torch.ops import align_cuda, detection_cuda, nms_cuda
from frp_tpu_torch.ops.align import invert_similarity
from frp_tpu_torch.ops.anchors import generate_anchors
from frp_tpu_torch.ops.nms import overlap_matrix
from frp_tpu_torch.testing.payloads import crowd_payload


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


@pytest.mark.cuda
@pytest.mark.parametrize("k", [256, 512, 1024])
def test_greedy_kernel_matches_plain(cuda, k):
    rng = np.random.default_rng(k)
    ctr = rng.uniform(0, 640, (4, k, 2))
    wh = rng.uniform(16, 160, (4, k, 2))
    boxes = torch.from_numpy(np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32))
    eff = overlap_matrix(boxes.to(cuda), 0.4, 0.5)
    above = torch.from_numpy(rng.random((4, k)) < 0.6).to(cuda)
    got = nms_cuda.greedy_suppress_kernel(eff, above, 1.0)
    want = nms_cuda.greedy_suppress_plain(eff, above, 1.0)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_greedy_kernel_refuses_k_above_1024(cuda):
    eff = torch.zeros((1, 1025, 1025), device=cuda)
    with pytest.raises(ValueError):
        nms_cuda.greedy_suppress_kernel(eff, torch.ones((1, 1025), dtype=torch.bool, device=cuda))
