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


@pytest.mark.cuda
@pytest.mark.parametrize("k,m", [(256, 16), (64, 8)])
def test_fused_head_kernel_matches_plain(cuda, k, m):
    priors = torch.from_numpy(generate_anchors(640).copy()).to(cuda)
    loc, ldm, scores = (torch.from_numpy(x).to(cuda) for x in
                        _random_head(np.random.default_rng(k), 8, priors.shape[0]))
    payload = detection_cuda.build_payload(loc, ldm, scores, priors, k)
    args = (m, 0.5, 0.4, 0.5, 640.0)
    got = detection_cuda.fused_head_kernel(payload, *args)
    want = detection_cuda.fused_head_plain(payload, *args)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got[..., 15].cpu().numpy(), want[..., 15].cpu().numpy())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_warp_kernel_matches_plain(cuda):
    rng = np.random.default_rng(1)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 640, 640, 3), dtype=np.uint8)).to(cuda)
    # mixed scales, rotations and centres, some past the border
    th = rng.uniform(-0.7, 0.7, (2, 16))
    s = rng.uniform(0.2, 2.5, (2, 16))
    a, b = s * np.cos(th), s * np.sin(th)
    c = rng.uniform(-40, 680, (2, 16, 2))
    mats = np.stack([np.stack([a, -b, 56 - (a * c[..., 0] - b * c[..., 1])], -1),
                     np.stack([b, a, 56 - (b * c[..., 0] + a * c[..., 1])], -1)], -2)
    inv = invert_similarity(torch.from_numpy(mats.astype(np.float32)).to(cuda))
    got = align_cuda.warp_crops_kernel(frames, inv, 112)
    want = align_cuda.warp_crops_plain(frames, inv, 112)
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
