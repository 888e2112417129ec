"""PyTorch port, the single-program pipeline: ``build_pipeline`` on the CPU
against the JAX package's ``build_pipeline`` and against the port's own staged
engine, and ``nms_padded`` / ``iou_matrix`` against ``frp_tpu.ops.nms``. On the
CPU the greedy pass is the plain version of kernel 3; the kernel itself is held
against it on the card by tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frp_tpu.config import load_config as j_load_config
from frp_tpu.engine.pipeline import RecognitionEngine as JEngine
from frp_tpu.engine.pipeline import build_pipeline as j_build_pipeline
from frp_tpu.ops import iou_matrix as j_iou_matrix
from frp_tpu.ops import nms_padded as j_nms_padded
from frp_tpu.ops.anchors import generate_anchors
from frp_tpu.train.synthetic import make_scene

import frp_tpu_torch.engine as t_engine
from frp_tpu_torch.config import load_config
from frp_tpu_torch.engine.pipeline import RecognitionEngine, build_pipeline
from frp_tpu_torch.ops import nms_cuda
from frp_tpu_torch.ops.nms import iou_matrix, nms_padded, nms_padded_batched

DET = 128
KW = dict(det_size=DET, max_faces_per_frame=4, pre_nms_topk=64,
          det_conf_threshold=0.3, compute_dtype="float32")
PIPE = dict(det_size=DET, max_faces=4, pre_nms_topk=64, conf_thresh=0.3,
            compute_dtype="float32")
KEYS = {"boxes", "scores", "landmarks", "valid", "count", "embeddings", "best_idx",
        "best_distance", "is_match", "topk_idx", "topk_distance", "fake_prob", "quality",
        "blur_score"}


def _boxes(rng, a, size=128.0):
    ctr = rng.uniform(0, size, (a, 2))
    wh = rng.uniform(8, 48, (a, 2))
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)


# --- nms_padded and iou_matrix ---------------------------------------------

def test_iou_matrix_matches_jax():
    boxes = _boxes(np.random.default_rng(0), 50)
    boxes[7] = boxes[3]  # identical boxes: IoU 1
    boxes[9, 2:] = boxes[9, :2]  # a box of no area: IoU 0, no division by zero
    got = iou_matrix(torch.from_numpy(boxes)).numpy()
    want = np.asarray(j_iou_matrix(jnp.asarray(boxes)))
    # the same f32 operations in the same order; 1e-6 for a last-bit difference
    # of the two frameworks' divisions
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[3, 7] == 1.0 and not got[9].any()


@pytest.mark.parametrize("seed,a,pre_topk,max_out,iom", [
    (0, 300, 64, 8, 0.5),   # more anchors than candidates
    (1, 40, 64, 8, 0.5),    # fewer anchors than pre_topk: K = A
    (2, 5, 64, 8, 0.0),     # fewer candidates than output slots: the padded pool; pure IoU
    (3, 300, 200, 16, 0.5),
])
def test_nms_padded_matches_jax_with_score_ties(seed, a, pre_topk, max_out, iom):
    """Scores rounded to two decimals tie often: the order among ties is the
    lower anchor index first, in both packages."""
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, a)
    scores = np.round(rng.uniform(0, 1, a), 2).astype(np.float32)
    scores[a // 2] = scores[0] = 0.9  # a tie whatever the draw
    ldm = rng.uniform(0, 128, (a, 10)).astype(np.float32)
    kw = dict(pre_topk=pre_topk, max_out=max_out, conf_thresh=0.5, iou_thresh=0.4, iom_thresh=iom)
    launches = nms_cuda.KERNEL.launches
    got = nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(ldm), **kw)
    assert nms_cuda.KERNEL.launches == launches  # CPU tensors: the plain version
    want = j_nms_padded(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(ldm), **kw)
    assert set(got) == set(want)
    for key in ("valid", "count"):
        assert got[key].shape == np.asarray(want[key]).shape, key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    for key in ("boxes", "scores", "landmarks"):
        # gathered inputs, not computed: 1e-5 is slack, they should be equal
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-5,
                                   err_msg=key)
    assert 0 < int(got["count"]) <= max_out
    # the single frame is the batched function's frame
    batched = nms_padded_batched(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None],
                                 torch.from_numpy(ldm)[None], **kw)
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(), batched[key][0].numpy(), err_msg=key)


# --- build_pipeline ----------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    return JEngine(j_load_config(**KW), seed=0), RecognitionEngine(load_config(**KW), device="cpu")


@pytest.fixture(scope="module")
def scene():
    """Three rendered portrait scenes [3, 128, 128, 3] uint8."""
    return np.stack([make_scene(DET, np.random.default_rng(s), max_faces=1, portrait=True)[0]
                     for s in (3, 5, 8)])


def _gallery(embeddings: np.ndarray, capacity=16):
    """Enrolled faces at distinct norms (an empty slot's zero query is nearest
    to the shortest entry; equal norms would make that a rounding tie) and
    random decoys, in a padded gallery with its valid mask."""
    rng = np.random.default_rng(0)
    rows = [*(embeddings * np.linspace(1.0, 0.8, len(embeddings), dtype=np.float32)[:, None]),
            *rng.normal(size=(5, embeddings.shape[1])).astype(np.float32)]
    gal = np.zeros((capacity, embeddings.shape[1]), np.float32)
    gal[: len(rows)] = rows
    return gal, np.arange(capacity) < len(rows)


def _run_torch(teng, frames, gal, gal_valid, **kw):
    pipeline = build_pipeline(device="cpu", **{**PIPE, **kw})
    out = pipeline(teng.params, torch.from_numpy(frames), torch.from_numpy(gal),
                   torch.from_numpy(gal_valid), teng._priors)
    return {k: v.numpy() for k, v in out.items()}


def test_build_pipeline_matches_jax_build_pipeline(engines, scene):
    jeng, teng = engines
    assert teng.distance_scale == pytest.approx(jeng.distance_scale)
    kw = dict(distance_scale=jeng.distance_scale, tolerance=0.6, top_k=3)
    priors = jax.device_put(generate_anchors(DET))
    jpipe = jax.jit(j_build_pipeline(**PIPE, **kw))

    def run_jax(gal, gal_valid):
        out = jpipe(jeng.params, jnp.asarray(scene), jnp.asarray(gal), jnp.asarray(gal_valid), priors)
        return {k: np.asarray(v) for k, v in jax.device_get(out).items()}

    empty = run_jax(np.zeros((16, 128), np.float32), np.zeros(16, bool))
    assert empty["valid"].sum() >= 3, "the shipped detector missed a face"
    gal, gal_valid = _gallery(empty["embeddings"][empty["valid"]])
    want = run_jax(gal, gal_valid)
    got = _run_torch(teng, scene, gal, gal_valid, **kw)
    assert set(got) == set(want) == KEYS
    for key in KEYS:
        assert got[key].shape == want[key].shape, key
    for key in ("valid", "count", "best_idx", "is_match"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert want["is_match"].sum() >= 3  # every enrolled face matches itself
    v = want["valid"]
    # f32 through two frameworks' convolutions, which sum in different orders:
    # the detector's boxes agree to 1e-3 px at det 128, unit-scale outputs
    # (embedding components, probabilities, quality in [0, 1]) to 1e-3, and
    # distances, which are differences of embeddings, likewise
    for key, atol in (("boxes", 1e-3), ("landmarks", 1e-3), ("scores", 1e-4),
                      ("embeddings", 1e-3), ("fake_prob", 1e-3), ("quality", 1e-3),
                      ("best_distance", 1e-3)):
        np.testing.assert_allclose(got[key][v], want[key][v], rtol=0, atol=atol, err_msg=key)
    np.testing.assert_array_equal(got["topk_idx"][v][:, 0], want["topk_idx"][v][:, 0])
    np.testing.assert_allclose(got["topk_distance"][v], want["topk_distance"][v], rtol=0, atol=1e-3)
    # blur_score is a Laplacian variance in the hundreds: relative
    np.testing.assert_allclose(got["blur_score"][v], want["blur_score"][v], rtol=1e-3, atol=1e-2)
    # padded slots are masked as the reference masks them
    assert np.all(got["boxes"][~v] == 0) and np.all(np.isinf(got["best_distance"][~v]))
    assert not got["is_match"][~v].any() and np.all(got["fake_prob"][~v] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_pipeline_equals_staged_engine(engines, scene, dtype):
    """One function and four chained stages compute the same (the JAX
    package's tests/test_engine.py::test_fused_equals_staged, its tolerances).
    The heads differ in route only: the pipeline's is decode +
    nms_padded_batched, the staged engine's the fused head's plain version."""
    _, f32 = engines
    teng = f32 if dtype == "float32" else RecognitionEngine(
        load_config(**{**KW, "compute_dtype": dtype}), device="cpu")
    first = teng.process_frames(scene)
    assert first["valid"].sum() >= 3
    gal, gal_valid = _gallery(first["embeddings"][first["valid"]], capacity=teng.gallery.capacity)
    teng.gallery.clear()
    for n, emb in enumerate(gal[gal_valid]):
        teng.gallery.add(f"id{n}", emb)
    staged = teng.process_frames(scene)
    fused = _run_torch(teng, scene, gal, gal_valid, compute_dtype=dtype,
                       distance_scale=teng.distance_scale,
                       tolerance=teng.cfg.face_tolerance)
    teng.gallery.clear()
    assert KEYS <= set(staged)
    for key in ("valid", "count", "best_idx", "is_match"):
        np.testing.assert_array_equal(fused[key], staged[key], err_msg=key)
    np.testing.assert_allclose(fused["boxes"], staged["boxes"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(fused["embeddings"], staged["embeddings"], atol=2e-2)
    np.testing.assert_allclose(fused["fake_prob"], staged["fake_prob"], atol=2e-2)
    np.testing.assert_allclose(fused["quality"], staged["quality"], atol=2e-2)


def test_build_pipeline_defaults_to_cuda_and_refuses_cpu_fallback():
    assert not torch.cuda.is_available()  # this suite runs on a CPU host
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_pipeline(**PIPE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_pipeline(device=None, **PIPE)
    build_pipeline(device="cpu", **PIPE)  # asked for: allowed


def test_engine_package_exports_what_the_jax_package_exports():
    import frp_tpu.engine as j_engine

    names = {"RecognitionEngine", "build_pipeline", "DeviceGallery"}
    assert names <= set(dir(j_engine)) and names <= set(dir(t_engine))
    assert t_engine.build_pipeline is build_pipeline
