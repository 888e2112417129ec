"""PyTorch port, kernels: each CUDA kernel's plain PyTorch version (what the
wrapper runs for CPU tensors) equals the JAX package's Pallas kernel, run as
the JAX tests run it on the CPU (interpret mode). The kernels themselves are
held against these plain versions on the card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frp_tpu.ops.align import warp_crops_batched as j_warp
from frp_tpu.ops.anchors import generate_anchors
from frp_tpu.ops.detection_pallas import fused_detection_head as j_head
from frp_tpu.ops.nms_pallas import greedy_suppress as j_greedy

from frp_tpu_torch.ops import align_cuda, detection_cuda, nms_cuda
from frp_tpu_torch.ops.align import invert_similarity
from frp_tpu_torch.testing.payloads import crowd_payload


def _random_head(rng, b, a):
    """The inputs of tests/test_detection_pallas.py::_random_head."""
    loc = rng.normal(0, 0.4, size=(b, a, 4)).astype(np.float32)
    ldm = rng.normal(0, 0.4, size=(b, a, 10)).astype(np.float32)
    scores = rng.uniform(0, 0.25, size=(b, a)).astype(np.float32)
    for i in range(b):
        hot = rng.choice(a, size=24, replace=False)
        scores[i, hot] = rng.uniform(0.5, 1.0, size=24)
    return loc, ldm, scores


def _compare_heads(got, want):
    # valid/count bit-equal; decoded floats within rtol 1e-4, atol 1e-3
    # (exp and the decode products may round differently across frameworks)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["count"].numpy(), np.asarray(want["count"]))
    v = np.asarray(want["valid"])
    for key, atol in (("boxes", 1e-3), ("landmarks", 1e-3), ("scores", 1e-5)):
        np.testing.assert_allclose(got[key].numpy()[v], np.asarray(want[key])[v],
                                   rtol=1e-4, atol=atol, err_msg=key)
        assert np.all(got[key].numpy()[~v] == 0), key


def _run_heads(loc, ldm, scores, priors, **kw):
    want = j_head(jnp.asarray(loc), jnp.asarray(ldm), jnp.asarray(scores), priors, **kw)
    got = detection_cuda.fused_detection_head(
        torch.from_numpy(loc), torch.from_numpy(ldm), torch.from_numpy(scores),
        torch.from_numpy(priors), **kw)
    return got, want


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_head_plain_matches_pallas(seed):
    priors = generate_anchors(128)
    loc, ldm, scores = _random_head(np.random.default_rng(seed), 3, priors.shape[0])
    got, want = _run_heads(loc, ldm, scores, priors, pre_topk=64, max_out=8,
                           conf_thresh=0.5, iou_thresh=0.4, image_size=128.0)
    _compare_heads(got, want)


def test_fused_head_plain_empty_and_full():
    priors = generate_anchors(128)
    a = priors.shape[0]
    loc = np.zeros((2, a, 4), np.float32)
    ldm = np.zeros((2, a, 10), np.float32)
    scores = np.zeros((2, a), np.float32)
    scores[1, :40] = 0.9  # frame 1: tied overlapping anchors -> NMS dedups
    got, want = _run_heads(loc, ldm, scores, priors, pre_topk=64, max_out=8, image_size=128.0)
    _compare_heads(got, want)
    assert int(got["count"][0]) == 0 and int(got["count"][1]) >= 1
    # "full": every slot taken by well-separated confident candidates
    rng = np.random.default_rng(2)
    loc, ldm, scores = _random_head(rng, 2, a)
    scores[:, : a // 2] = np.float32(0.95)
    got, want = _run_heads(loc, ldm, scores, priors, pre_topk=64, max_out=8,
                           conf_thresh=0.5, iom_thresh=0.0, image_size=128.0)
    _compare_heads(got, want)
    assert got["count"].min() == 8


def test_fused_head_above_256_routes_to_nms():
    priors = generate_anchors(128)
    loc, ldm, scores = _random_head(np.random.default_rng(4), 2, priors.shape[0])
    got, want = _run_heads(loc, ldm, scores, priors, pre_topk=300, max_out=8, image_size=128.0)
    _compare_heads(got, want)


@pytest.mark.parametrize("k", [64, 200])
def test_greedy_plain_matches_pallas(k):
    rng = np.random.default_rng(k)
    eff = rng.uniform(0, 2.0, (3, k, k)).astype(np.float32)
    eff[0, 5, 6:] = 1.0  # exactly at the threshold: not suppressed
    above = rng.random((3, k)) < 0.7
    want = np.asarray(j_greedy(jnp.asarray(eff), jnp.asarray(above), 1.0))
    got = nms_cuda.greedy_suppress(torch.from_numpy(eff), torch.from_numpy(above), 1.0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_warp_plain_matches_exact_warp():
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (2, 64, 80, 3), dtype=np.uint8)
    # integer-scaled, unrotated faces: every sample coordinate is exact in
    # f32, so the two bilinear samplers agree bit for bit even on noise
    mats = np.zeros((2, 2, 2, 3), np.float32)
    mats[..., 0, 0] = mats[..., 1, 1] = [[2.0, 4.0], [1.0, 2.0]]
    mats[..., 0, 2] = [[-10.0, -200.0], [20.0, -40.0]]
    mats[..., 1, 2] = [[-6.0, 8.0], [-30.0, -100.0]]
    want = np.asarray(j_warp(jnp.asarray(frames.astype(np.float32)), jnp.asarray(mats), 32))
    inv = invert_similarity(torch.from_numpy(mats))
    got = align_cuda.warp_crops(torch.from_numpy(frames), inv, 32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,n_above", [(0, 24), (1, 1), (2, 63)])
def test_fused_head_ignores_overlaps_of_candidates_below_threshold(seed, n_above):
    """The greedy pass ORs in row i only when rank i is above the score
    threshold, and keep = above & ~suppressed (frp_tpu/ops/nms.py, the loop of
    nms_padded_batched): so the overlap of a pair matters only when both of
    its candidates are above. The CUDA head builds no other bit of its mask.
    Moving every box below the threshold onto the boxes above it changes
    those overlaps from mostly 0 to mostly > 1 and must change nothing."""
    rng = np.random.default_rng(seed)
    k, m = 64, 8
    payload = crowd_payload(rng, 3, k, n_above)
    moved = payload.copy()
    # each row below takes the prior and the deltas of a row above: its box
    # then coincides with that box (overlap far above 1 with it and its crowd)
    src = rng.integers(0, n_above, (3, k - n_above))
    for f in range(3):
        moved[f, n_above:, :18] = payload[f, src[f], :18]
    args = (m, 0.5, 0.4, 0.5, 640.0)
    got = detection_cuda.fused_head_plain(torch.from_numpy(payload), *args)
    got_moved = detection_cuda.fused_head_plain(torch.from_numpy(moved), *args)
    np.testing.assert_array_equal(got.numpy(), got_moved.numpy())
    assert got[..., 15].sum() >= 3  # something is kept in every frame

    # the same on the JAX reference, from the boxes the port decodes
    from frp_tpu.ops.nms import nms_padded_batched as j_nms
    from frp_tpu_torch.ops.decode import decode_boxes, decode_landmarks

    def reference(p):
        t = torch.from_numpy(p)
        boxes = decode_boxes(t[..., 0:4], t[..., 14:18], 640.0).numpy()
        ldm = decode_landmarks(t[..., 4:14], t[..., 14:18], 640.0).numpy()
        return j_nms(jnp.asarray(boxes), jnp.asarray(p[..., 18]), jnp.asarray(ldm),
                     pre_topk=k, max_out=m, conf_thresh=0.5, iou_thresh=0.4,
                     iom_thresh=0.5, use_pallas=False)

    want, want_moved = reference(payload), reference(moved)
    for key in ("valid", "count", "boxes", "scores"):
        np.testing.assert_array_equal(np.asarray(want[key]), np.asarray(want_moved[key]), err_msg=key)
    np.testing.assert_array_equal(got[..., 15].numpy() > 0.5, np.asarray(want["valid"]))
    np.testing.assert_allclose(got[..., 0:4].numpy(), np.asarray(want["boxes"]), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("junk", [0.0, 2.0, 1e30])
@pytest.mark.parametrize("k,p_above", [(64, 0.6), (200, 0.1)])
def test_greedy_suppress_ignores_what_the_pass_cannot_read(k, p_above, junk):
    """The greedy pass reads eff[i, j] only for j > i with ranks i and j both
    above the score threshold: rank i suppresses only when it is above, only
    lower ranks, and keep = above & ~suppressed. The CUDA kernel loads no other
    entry. Overwriting every other entry (rows and columns of candidates
    below, the diagonal and everything left of it) with 0, with a value above
    the threshold or with 1e30 must leave the keep mask as it is, in the
    port's plain version and in the JAX package's Pallas kernel."""
    rng = np.random.default_rng(k)
    eff = rng.uniform(0, 2.0, (3, k, k)).astype(np.float32)
    above = rng.random((3, k)) < p_above
    both = above[:, :, None] & above[:, None, :]
    right = np.triu(np.ones((k, k), bool), 1)
    dirty = np.where(both & right, eff, np.float32(junk))
    assert (dirty != eff).mean() > 0.5
    got = nms_cuda.greedy_suppress(torch.from_numpy(eff), torch.from_numpy(above), 1.0).numpy()
    got_dirty = nms_cuda.greedy_suppress(torch.from_numpy(dirty), torch.from_numpy(above), 1.0).numpy()
    np.testing.assert_array_equal(got_dirty, got)
    want = np.asarray(j_greedy(jnp.asarray(eff), jnp.asarray(above), 1.0))
    want_dirty = np.asarray(j_greedy(jnp.asarray(dirty), jnp.asarray(above), 1.0))
    np.testing.assert_array_equal(want_dirty, want)
    np.testing.assert_array_equal(got, want)
    assert got.any() and (got != above).any()  # something is kept, something suppressed
