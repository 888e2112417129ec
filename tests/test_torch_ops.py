"""PyTorch port, ops: image conversion, NMS, alignment warp, quality and
gallery matching equal the JAX package's on the same numpy inputs (each
tolerance with its reason beside it)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frp_tpu.ops import align as jalign
from frp_tpu.ops import image as jimage
from frp_tpu.ops import matching as jmatch
from frp_tpu.ops import nms as jnms
from frp_tpu.ops import quality as jquality

from frp_tpu_torch.ops import align as talign
from frp_tpu_torch.ops import image as timage
from frp_tpu_torch.ops import matching as tmatch
from frp_tpu_torch.ops import nms as tnms
from frp_tpu_torch.ops import quality as tquality


def _smooth_frames(rng, b, h, w, passes=3):
    f = rng.normal(128, 60, size=(b, h, w, 3)).astype(np.float32)
    for _ in range(passes):
        f = (np.roll(f, 1, 1) + f + np.roll(f, -1, 1)) / 3
        f = (np.roll(f, 1, 2) + f + np.roll(f, -1, 2)) / 3
    return np.clip(f, 0, 255).astype(np.uint8)


def test_yuv420_to_rgb_uint8_matches():
    # XLA may contract an FMA in the BT.601 sums: at most 1 LSB on < 0.1 %
    yuv = np.random.default_rng(0).integers(0, 256, (2, 96 * 3 // 2, 128), dtype=np.uint8)
    want = np.asarray(jimage.yuv420_to_rgb(jnp.asarray(yuv)).astype(jnp.uint8)).astype(int)
    got = timage.yuv420_to_rgb(torch.from_numpy(yuv)).to(torch.uint8).numpy().astype(int)
    diff = np.abs(got - want)
    assert diff.max() <= 1 and np.mean(diff > 0) < 1e-3


def test_preprocess_frames_non_square():
    # the antialiased bilinear kernels of the two frameworks differ in edge
    # handling: within 1.0 of 255 after de-normalizing
    frames = _smooth_frames(np.random.default_rng(1), 2, 96, 160)
    xj, sj = jimage.preprocess_frames(jnp.asarray(frames), 64, "float32")
    xt, st = timage.preprocess_frames(torch.from_numpy(frames), 64, "float32")
    np.testing.assert_allclose(xt.numpy() * 128.0, np.asarray(xj) * 128.0, atol=1.0)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_normalizers_match():
    x = np.random.default_rng(2).uniform(0, 255, (3, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(
        timage.normalize_imagenet(torch.from_numpy(x)).numpy(),
        np.asarray(jimage.normalize_imagenet(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        timage.normalize_face(torch.from_numpy(x)).numpy(),
        np.asarray(jimage.normalize_face(jnp.asarray(x))))


def _nms_inputs(rng, b, a, tie):
    ctr = rng.uniform(10, 110, (b, a, 2))
    wh = rng.uniform(8, 40, (b, a, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, a)).astype(np.float32)
    if tie:  # heavy ties, incl. at the top-k boundary and among kept boxes
        scores = (np.round(scores * 4) / 4).astype(np.float32)
    ldm = rng.uniform(0, 128, (b, a, 10)).astype(np.float32)
    return boxes, scores, ldm


@pytest.mark.parametrize("tie,kw", [
    (False, dict(pre_topk=64, max_out=8)),
    (True, dict(pre_topk=64, max_out=8)),
    (True, dict(pre_topk=32, max_out=40, iom_thresh=0.0)),
    (False, dict(pre_topk=300, max_out=16, conf_thresh=0.3)),
])
def test_nms_padded_batched_matches(tie, kw):
    boxes, scores, ldm = _nms_inputs(np.random.default_rng(3), 3, 400, tie)
    want = jnms.nms_padded_batched(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(ldm), **kw)
    got = tnms.nms_padded_batched(torch.from_numpy(boxes), torch.from_numpy(scores),
                                  torch.from_numpy(ldm), **kw)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["count"].numpy(), np.asarray(want["count"]))
    for key in ("boxes", "landmarks", "scores"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


def test_overlap_matrix_matches():
    boxes, _, _ = _nms_inputs(np.random.default_rng(4), 1, 50, False)
    want = np.asarray(jnms.overlap_matrix(jnp.asarray(boxes[0]), 0.4, 0.5))
    got = tnms.overlap_matrix(torch.from_numpy(boxes[0]), 0.4, 0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _rot_template(tmpl, deg):
    th = np.deg2rad(deg)
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
    ctr = tmpl.mean(0)
    return (tmpl - ctr) @ rot.T + ctr


def test_similarity_and_inverse_match():
    rng = np.random.default_rng(5)
    tmpl = talign.ARCFACE_TEMPLATE_112
    ldm = np.stack([_rot_template(tmpl, rng.uniform(-20, 20)) * rng.uniform(0.3, 2)
                    + rng.uniform(0, 300, 2) for _ in range(6)]).astype(np.float32)
    want = np.asarray(jalign.similarity_transform(jnp.asarray(ldm), jnp.asarray(tmpl)))
    got = talign.similarity_transform(torch.from_numpy(ldm), torch.from_numpy(tmpl)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        talign.invert_similarity(torch.from_numpy(want.copy())).numpy(),
        np.asarray(jalign.invert_similarity(jnp.asarray(want))), rtol=1e-5, atol=1e-4)


def _forward(scale, cx, cy, deg=0.0, out_size=112):
    """source px -> out px for a `scale`-px face centred at (cx, cy)."""
    s = out_size / scale
    th = np.deg2rad(deg)
    a, b = s * np.cos(th), s * np.sin(th)
    return np.array([[a, -b, out_size / 2 - (a * cx - b * cy)],
                     [b, a, out_size / 2 - (b * cx + a * cy)]], np.float32)


def test_warp_crops_batched_matches_exact_warp():
    # smoothed frames: an f32 ulp in a sample coordinate moves the bilinear
    # value by far less than atol 1e-3 (a floor tie on noise would not)
    frames = _smooth_frames(np.random.default_rng(6), 2, 160, 192)
    cases = [
        [(40, 60, 70, 8), (30, 180, 20, -12), (60, 100, 150, 3)],   # mid, edge, partly out
        [(200, 96, 80, 0), (24, 2, 158, 20), (90, 190, 5, -30)],    # fills the square, corners
    ]
    mats = np.stack([[_forward(*c) for c in frame] for frame in cases])
    want = np.asarray(jalign.warp_crops_batched(
        jnp.asarray(frames.astype(np.float32)), jnp.asarray(mats), 112))
    got = talign.warp_crops_batched(torch.from_numpy(frames), torch.from_numpy(mats), 112)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_assess_quality_batch_matches():
    rng = np.random.default_rng(7)
    crops = _smooth_frames(rng, 6, 112, 112, passes=1).astype(np.float32)
    xy = rng.uniform(0, 100, (6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 60, (6, 2))], 1).astype(np.float32)
    valid = np.array([1, 1, 0, 1, 0, 1], bool)
    want = jquality.assess_quality_batch(jnp.asarray(crops), jnp.asarray(boxes), (128, 160), jnp.asarray(valid))
    got = tquality.assess_quality_batch(torch.from_numpy(crops), torch.from_numpy(boxes), (128, 160), torch.from_numpy(valid))
    for key in want:  # f32 mean/variance reductions sum in other orders
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-3, err_msg=key)


@pytest.mark.parametrize("n,tied", [(256, False), (300, True), (16384 + 1024 * 2, True), (16384 + 1024 * 3, False)])
def test_gallery_match_matches(n, tied):
    rng = np.random.default_rng(n)
    d = 16
    if tied:
        # half-integer entries make every dot product exact in f32, so
        # duplicated rows give bit-equal distances in both frameworks
        gal = (rng.integers(-2, 3, (n, d)) / 2.0).astype(np.float32)
        gal[n // 2 :: 7] = gal[3]  # many exact duplicates of row 3
        q = np.concatenate([gal[[3, 10, n - 1]], np.zeros((1, d), np.float32)])
    else:
        gal = rng.normal(size=(n, d)).astype(np.float32)
        q = rng.normal(size=(4, d)).astype(np.float32)
    valid = rng.random(n) > 0.1
    valid[3] = True
    want = jmatch.gallery_match(jnp.asarray(q), jnp.asarray(gal), jnp.asarray(valid), top_k=5)
    got = tmatch.gallery_match(torch.from_numpy(q), torch.from_numpy(gal), torch.from_numpy(valid), top_k=5)
    for key in ("best_idx", "topk_idx", "is_match"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["topk_distance"].numpy(), np.asarray(want["topk_distance"]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("boxes", [
    [[10.0, 20.0, 50.0, 90.0], [0.0, 0.0, 112.0, 112.0], [30.5, 40.25, 31.0, 40.5]],
    [[5.0, 5.0, 5.0, 5.0], [100.0, 50.0, 60.0, 10.0], [-20.0, -10.0, 300.0, 140.0]],  # empty, inverted
])
@pytest.mark.parametrize("out_size", [112, 224])
def test_bbox_crop_matrices_match(boxes, out_size):
    b = np.asarray(boxes, np.float32)
    want = np.asarray(jalign.bbox_crop_matrices(jnp.asarray(b), out_size))
    got = talign.bbox_crop_matrices(torch.from_numpy(b), out_size).numpy()
    assert got.shape == want.shape == (3, 2, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_warp_crops_by_frame_index_match():
    """JAX's warp_crops (faces of any frames, picked by index; float frames)
    against the port's, within 1e-4 on unit-range frames: similarity crops,
    bbox crops, and degenerate matrices whose sample coordinates reach 1e12
    (clamped to the border in float space before the integer conversion).
    The two differ by f32 rounding only: XLA's fused arithmetic under jit and
    one ulp of the inverse's einsum move a 0-255 crop by up to 8 ulps
    (1.2e-4 at 130); the sampler alone, fed the same coordinates, is equal
    bit for bit on 0-255 frames."""
    pixels = _smooth_frames(np.random.default_rng(8), 3, 120, 160, passes=6).astype(np.float32)
    frames = pixels / np.float32(255.0)
    mats = np.stack([
        _forward(60, 50, 40, 10), _forward(90, 150, 100, -25), _forward(30, 5, 115, 0),
        *np.asarray(jalign.bbox_crop_matrices(jnp.asarray([[20.0, 30.0, 80.0, 100.0],
                                                           [140.0, 0.0, 160.0, 20.0]]), 112)),
        np.array([[1e-12, 0.0, 0.0], [0.0, 1e-12, 0.0]], np.float32),   # coords ~1e12
        np.array([[-1e-10, 1e-10, 3.0], [1e-10, 1e-10, -5.0]], np.float32),
    ]).astype(np.float32)
    idx = np.array([0, 2, 1, 1, 0, 2, 1], np.int32)
    want = np.asarray(jalign.warp_crops(jnp.asarray(frames), jnp.asarray(mats), jnp.asarray(idx), 112))
    got = talign.warp_crops(torch.from_numpy(frames), torch.from_numpy(mats), torch.from_numpy(idx), 112)
    assert got.dtype == torch.float32 and got.shape == want.shape == (7, 112, 112, 3)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # the sampler alone on a 0-255 frame: coordinates inside, on the border
    # and far past it, and a crop's grid
    grid = np.arange(112, dtype=np.float32) * np.float32(1.37) - np.float32(3.1)
    xs = np.concatenate([[0.0, 0.5, 159.0, 158.999, 1e12, -1e12], grid]).astype(np.float32)
    ys = np.concatenate([[0.0, 119.0, 60.25, -3.0, 1e12, 7.5], grid[::-1]]).astype(np.float32)
    got = talign._bilinear_sample(torch.from_numpy(pixels[1]), torch.from_numpy(xs),
                                  torch.from_numpy(ys)).numpy()
    want = np.asarray(jalign._bilinear_sample(jnp.asarray(pixels[1]), jnp.asarray(xs), jnp.asarray(ys)))
    np.testing.assert_array_equal(got, want)
