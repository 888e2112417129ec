"""PyTorch port, the spoof and quality switches on the CPU against the JAX
package: ``build_pipeline`` with spoof off, quality off and other spoof crop
sizes against the JAX ``build_pipeline`` with the same settings (the same
outputs absent, integer and mask outputs bit for bit, floats at
tests/test_torch_pipeline.py's tolerances), the spoof crops' resize against
``jax.image.resize``, the embed stage's compaction without spoof against the
uncompacted stage, and ``RecognitionEngine(with_spoof=False)`` against the
JAX engine built so."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frp_tpu.config import load_config as j_load_config
from frp_tpu.engine.pipeline import RecognitionEngine as JEngine
from frp_tpu.engine.pipeline import build_pipeline as j_build_pipeline
from frp_tpu.ops.anchors import generate_anchors
from frp_tpu.train.synthetic import make_scene

from frp_tpu_torch.config import load_config
from frp_tpu_torch.engine.pipeline import RecognitionEngine, build_stages, resize_crops
from tests.test_torch_pipeline import DET, KEYS, KW, PIPE, _gallery, _run_torch


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs its files in parallel worker processes: two intra-op
    threads a test keep those from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    return JEngine(j_load_config(**KW), seed=0), RecognitionEngine(load_config(**KW), device="cpu")


@pytest.fixture(scope="module")
def scene():
    """Three rendered portrait scenes [3, 128, 128, 3] uint8."""
    return np.stack([make_scene(DET, np.random.default_rng(s), max_faces=1, portrait=True)[0]
                     for s in (3, 5, 8)])


@pytest.fixture(scope="module")
def defaults(engines, scene):
    """The JAX pipeline's default results on the scenes with an empty
    gallery, and a gallery of their faces."""
    jeng, _ = engines
    jpipe = jax.jit(j_build_pipeline(**PIPE, distance_scale=jeng.distance_scale))
    priors = jax.device_put(generate_anchors(DET))
    out = jpipe(jeng.params, jnp.asarray(scene), jnp.zeros((16, 128)), jnp.zeros(16, bool), priors)
    out = {k: np.asarray(v) for k, v in jax.device_get(out).items()}
    assert out["valid"].sum() >= 3, "the shipped detector missed a face"
    return out, _gallery(out["embeddings"][out["valid"]])


@pytest.mark.parametrize("with_spoof,with_quality,spoof_size", [
    (False, True, 112), (True, False, 112), (True, True, 64), (True, True, 224)])
def test_build_pipeline_switches_match_jax(engines, scene, defaults, with_spoof, with_quality,
                                           spoof_size):
    """Each switch as in the JAX pipeline: the outputs switched off are
    absent from both, integer and mask outputs bit for bit, floats at
    test_build_pipeline_matches_jax_build_pipeline's tolerances."""
    jeng, teng = engines
    base, (gal, gal_valid) = defaults
    kw = dict(distance_scale=jeng.distance_scale, tolerance=0.6, top_k=3, with_spoof=with_spoof,
              with_quality=with_quality, spoof_size=spoof_size)
    jpipe = jax.jit(j_build_pipeline(**PIPE, **kw))
    want = jpipe(jeng.params, jnp.asarray(scene), jnp.asarray(gal), jnp.asarray(gal_valid),
                 jax.device_put(generate_anchors(DET)))
    want = {k: np.asarray(v) for k, v in jax.device_get(want).items()}
    got = _run_torch(teng, scene, gal, gal_valid, **kw)
    absent = (set() if with_spoof else {"fake_prob"}) | (set() if with_quality else {"quality", "blur_score"})
    assert set(got) == set(want) == KEYS - absent
    for key in ("valid", "count", "best_idx", "is_match", "topk_idx"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    v = want["valid"]
    for key, atol in (("boxes", 1e-3), ("landmarks", 1e-3), ("scores", 1e-4), ("embeddings", 1e-3),
                      ("fake_prob", 1e-3), ("quality", 1e-3), ("best_distance", 1e-3)):
        if key in want:
            np.testing.assert_allclose(got[key][v], want[key][v], rtol=0, atol=atol, err_msg=key)
    if "blur_score" in want:
        np.testing.assert_allclose(got["blur_score"][v], want["blur_score"][v], rtol=1e-3, atol=1e-2)
    if spoof_size != 112:  # the resize reaches the spoof net
        assert np.abs(got["fake_prob"][v] - base["fake_prob"][v]).max() > 1e-4
    np.testing.assert_allclose(got["embeddings"][v], base["embeddings"][v], rtol=0, atol=1e-3)


@pytest.mark.parametrize("size", [64, 96, 224])
def test_resize_crops_matches_jax_image_resize(size):
    """Bilinear at pixel centres, antialiased when shrinking, as
    jax.image.resize; f32 rounding of the two weight computations apart."""
    crops = np.random.default_rng(size).uniform(0, 255, (3, 112, 112, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(crops), (3, size, size, 3), method="bilinear"))
    got = resize_crops(torch.from_numpy(crops), size).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_engine_without_spoof_matches_jax(scene):
    """RecognitionEngine(with_spoof=False) against the JAX engine built so:
    packed results (the fake_prob column zeros), the full tree without
    fake_prob, and encode_image's faces (fake_prob None)."""
    jeng = JEngine(j_load_config(**KW), seed=0, with_spoof=False)
    teng = RecognitionEngine(load_config(**KW), device="cpu", with_spoof=False)
    assert teng.with_spoof is False
    want, got = jeng.fetch(jeng.submit(scene)), teng.fetch(teng.submit(scene))
    assert want["valid"].sum() >= 3
    for key in ("valid", "count", "best_idx", "is_match"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert not got["fake_prob"].any() and not want["fake_prob"].any()
    v = want["valid"]
    for key, atol in (("boxes", 1e-2), ("quality", 1e-2), ("best_distance", 1e-4)):
        np.testing.assert_allclose(got[key][v], want[key][v], rtol=0, atol=atol, err_msg=key)
    full = teng.process_frames(scene)
    assert "fake_prob" not in full and "fake_prob" not in jeng.process_frames(scene)
    jfaces, tfaces = jeng.encode_image(scene[0]), teng.encode_image(scene[0])
    assert len(tfaces) == len(jfaces) >= 1
    for jf, tf in zip(jfaces, tfaces):
        assert tf.keys() == jf.keys() and tf["fake_prob"] is None and jf["fake_prob"] is None
        np.testing.assert_allclose(tf["box"], jf["box"], atol=1e-2)
        np.testing.assert_allclose(tf["embedding"], jf["embedding"], atol=1e-3)
        assert tf["quality"] == pytest.approx(jf["quality"], abs=1e-2)


def test_compaction_without_spoof_equals_the_uncompacted_stage(engines):
    """The embed stage without spoof, compacted (64 slots: rungs 8, 32, 52)
    and not, on the same crops: equal embeddings, no fake_prob."""
    _, teng = engines
    rng = np.random.default_rng(4)
    crops = torch.from_numpy(rng.uniform(0, 255, (16, 4, 112, 112, 3)).astype(np.float32))
    compacted, plain = (build_stages(device="cpu", det_size=DET, max_faces=4, with_spoof=False,
                                     compute_dtype="float32", compact=c)["embed"]
                        for c in (True, False))
    with torch.no_grad():
        # the uncompacted stage embeds every slot on its own, then masks
        every = plain(teng.params, crops, torch.ones((16, 4), dtype=torch.bool), 0.9)
        assert set(every) == {"embeddings_flat"}
        for nv in (5, 40):  # the rungs of 8 and 52 slots
            valid = torch.zeros(64, dtype=torch.bool)
            valid[torch.from_numpy(rng.permutation(64)[:nv])] = True
            got = compacted(teng.params, crops, valid.reshape(16, 4), 0.9)
            assert set(got) == {"embeddings_flat"}
            want = torch.where(valid[:, None], every["embeddings_flat"], 0.0)
            np.testing.assert_allclose(got["embeddings_flat"].numpy(), want.numpy(), rtol=0, atol=1e-5)
