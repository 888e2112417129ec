"""PyTorch port, training (3 of 3): synthetic data, pair metrics, checkpoints,
the weights round trip between the packages and the training entry points,
on the CPU against the JAX package.

- Every ``train/synthetic.py`` function gives the JAX package's arrays bit
  for bit for the same seed (numpy draws and cv2 calls on both sides).
- The pair metrics on the same embeddings: equal (float64 numpy on both).
- ``embed_crops`` against the JAX package's with the shipped weights: within
  1e-4 (embeddings of unit norm, f32, the two frameworks' conv orders).
- A checkpoint resumes to the same next step as an uninterrupted trainer,
  bit for bit; a checkpoint of another configuration is refused.
- Weights the port trains load into the JAX package's ``load_params`` and
  embed there as in the port, within 1e-4; and the reverse.
- The four tools' ``main`` at tiny arguments on the CPU.
"""

import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

from frp_tpu.models.mobilefacenet import mobilefacenet_forward as j_mfn
from frp_tpu.models.params import load_params as j_load_params
from frp_tpu.models.params import save_params as j_save_params
from frp_tpu.train import pairs as jpairs
from frp_tpu.train import synthetic as jsyn
from frp_tpu.train.arcface import _flatten_tree as j_flatten_tree

from frp_tpu_torch.models.mobilefacenet import init_mobilefacenet, mobilefacenet_forward
from frp_tpu_torch.models.params import (
    convert_params,
    count_params,
    deterministic_params,
    flatten_params,
    load_params,
    save_params,
    to_numpy_params,
)
from frp_tpu_torch.testing import synthetic as tsyn_testing
from frp_tpu_torch.train import pairs as tpairs
from frp_tpu_torch.train import synthetic as tsyn
from frp_tpu_torch.train.arcface import ArcFaceTrainer
from frp_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from frp_tpu_torch.train.classifier import SpoofTrainer
from frp_tpu_torch.tools import fl_client, pretrain_embedder, pretrain_spoof, pretrain_synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs its files in parallel worker processes: two intra-op
    threads a test keep those from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --- synthetic data, bit for bit ---------------------------------------------

def test_tiers_and_mix_equal():
    assert tsyn.TIERS == jsyn.TIERS and tsyn.TIER_MIX == jsyn.TIER_MIX


@pytest.mark.parametrize("tier", [0, 1, 2, 3])
def test_pose_tier_photometric_jpeg_blur_equal(tier):
    for fn in (lambda s, r: s.sample_pose(r, tier),
               lambda s, r: [s._pick_tier(r, d) for d in (None, "mix", 2, (0.1, 0.2, 0.3, 0.4))],
               lambda s, r: s.apply_photometric(r.integers(0, 255, (48, 64, 3), dtype=np.uint8), r, tier),
               lambda s, r: s.jpeg_roundtrip(r.integers(0, 255, (32, 32, 3), dtype=np.uint8), 40),
               lambda s, r: s._motion_blur(r.random((20, 24, 3)).astype(np.float32), 5, 0.7)):
        _equal(fn(tsyn, np.random.default_rng(tier)), fn(jsyn, np.random.default_rng(tier)))


@pytest.mark.parametrize("difficulty", [None, 1, "mix"])
def test_identity_crops_and_renders_equal(difficulty):
    for seed in (3, 4):
        _equal(tsyn.make_identity(seed), jsyn.make_identity(seed))
        ident = jsyn.make_identity(seed)
        for fn in (lambda s, r: s.make_identity_crop(ident, r, difficulty=difficulty),
                   lambda s, r: s.make_identity_crop(ident, r, size=150, difficulty=difficulty),
                   lambda s, r: s.make_serving_crop(ident, r, difficulty=difficulty),
                   lambda s, r: s.make_scene(96, r, 3, difficulty=difficulty),
                   lambda s, r: s._resize_bilinear(r.integers(0, 255, (50, 50, 3), dtype=np.uint8), 32,
                                                   linear=bool(seed % 2))):
            _equal(fn(tsyn, np.random.default_rng(seed)), fn(jsyn, np.random.default_rng(seed)))
        canvas_t, canvas_j = np.zeros((80, 90, 3), np.uint8), np.zeros((80, 90, 3), np.uint8)
        _equal(tsyn.render_face(canvas_t, 40.0, 42.0, 50.0, np.random.default_rng(seed), ident,
                                pose=(0.3, -0.2, 0.1), occlusion=0.3),
               jsyn.render_face(canvas_j, 40.0, 42.0, 50.0, np.random.default_rng(seed), ident,
                                pose=(0.3, -0.2, 0.1), occlusion=0.3))
        _equal(canvas_t, canvas_j)


@pytest.mark.parametrize("difficulty,portrait_frac", [(None, 0.0), ("mix", 0.5)])
def test_make_batch_equal(difficulty, portrait_frac):
    got = tsyn.make_batch(3, 64, np.random.default_rng(8), difficulty=difficulty,
                          portrait_frac=portrait_frac)
    want = jsyn.make_batch(3, 64, np.random.default_rng(8), difficulty=difficulty,
                           portrait_frac=portrait_frac)
    _equal(got, want)


def test_one_copy_of_the_renderer():
    """testing/synthetic.py imports the renderer instead of keeping a copy."""
    assert tsyn_testing.make_scene is tsyn.make_scene
    assert tsyn_testing.render_face is tsyn.render_face
    assert tsyn_testing.make_identity is tsyn.make_identity


# --- pairs ---------------------------------------------------------------------

def test_pair_fixtures_and_metrics_equal():
    _equal(tpairs.build_pair_crops(3, 2, seed=9000, size=64, difficulty="mix"),
           jpairs.build_pair_crops(3, 2, seed=9000, size=64, difficulty="mix"))
    crop = jsyn.make_identity_crop(jsyn.make_identity(1), np.random.default_rng(1))
    _equal(tpairs.jitter_crop(crop, np.random.default_rng(2)), jpairs.jitter_crop(crop, np.random.default_rng(2)))
    _equal(tpairs.build_scene_set(2, 1, hw=(120, 160), difficulty=1),
           jpairs.build_scene_set(2, 1, hw=(120, 160), difficulty=1))
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(12, 8))
    labels = np.repeat(np.arange(4), 3)
    same, diff = tpairs.pair_distances(emb, labels)
    _equal((same, diff), jpairs.pair_distances(emb, labels))
    assert tpairs.eer_sweep(same, diff) == jpairs.eer_sweep(same, diff)
    assert tpairs.threshold_metrics(same, diff) == jpairs.threshold_metrics(same, diff)
    with pytest.raises(ValueError, match="need both pair populations"):
        tpairs.threshold_metrics(same[:0], diff)


@pytest.mark.parametrize("flip", [False, True])
def test_embed_crops_equal_jax(flip):
    crops, _ = jpairs.build_pair_crops(2, 2, seed=9100)
    want = jpairs.embed_crops(crops, flip=flip)
    got = tpairs.embed_crops(crops, flip=flip, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-4)
    params = j_load_params(os.path.join(REPO, "weights", "mobilefacenet.npz"))
    np.testing.assert_allclose(tpairs.embed_crops(crops, params=jax.device_get(params), device="cpu"),
                               jpairs.embed_crops(crops, params=params), atol=1e-4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpairs.embed_crops(crops)


def test_embed_scenes_runs_the_engine():
    from frp_tpu_torch.config import load_config
    from frp_tpu_torch.engine.pipeline import RecognitionEngine

    scenes, labels = tpairs.build_scene_set(2, 1, hw=(240, 320))
    eng = RecognitionEngine(load_config(det_size=128, max_faces_per_frame=4), device="cpu")
    embs, got_labels = tpairs.embed_scenes(eng, scenes, labels)
    assert embs.shape == (len(got_labels), 128) and len(got_labels) >= 1
    raw, _ = tpairs.embed_scenes(eng, scenes, labels, apply_calibration=False)
    np.testing.assert_allclose(raw * eng.distance_scale, embs, rtol=1e-6)


# --- parameter files, both ways ------------------------------------------------

def test_params_helpers():
    tree = init_mobilefacenet(0)
    assert count_params(tree) == count_params(convert_params(tree)) == 1022720
    _equal(deterministic_params(init_mobilefacenet, 3), init_mobilefacenet(3))
    _equal(flatten_params(to_numpy_params(convert_params(tree))), flatten_params(tree))


def test_port_weights_load_into_jax_and_back(tmp_path):
    """Weights the port trained, saved by the port, embed in the JAX
    package as in the port; a file the JAX package wrote loads into the
    port."""
    crops, labels = jpairs.build_pair_crops(2, 2, seed=9200)
    tt = ArcFaceTrainer(num_classes=2, seed=0, learning_rate=0.05, compute_dtype="float32",
                        device="cpu")
    tt.train_step(crops.astype(np.uint8), labels)
    path = str(tmp_path / "mfn.npz")
    save_params(path, tt.embedder_params())
    x = (crops.astype(np.float32) - 127.5) / 128.0
    with torch.no_grad():
        want = mobilefacenet_forward(tt.state["params"]["backbone"], torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(j_mfn(j_load_params(path), x)), want, atol=1e-4)
    # a tensor tree saves the same file as its numpy tree
    path2 = str(tmp_path / "mfn2.npz")
    save_params(path2, tt.state["params"]["backbone"])
    _equal(dict(np.load(path)), dict(np.load(path2)))
    # the JAX package's file (with a None leaf: MobileNetV3's absent expand)
    from frp_tpu.models.mobilenetv3 import init_mobilenetv3_small as j_init_mnv3

    jpath = str(tmp_path / "spoof.npz")
    j_save_params(jpath, j_init_mnv3(1))
    got = load_params(jpath)
    assert got["blocks"][0]["expand"] is None
    save_params(str(tmp_path / "again.npz"), got)
    _equal(dict(np.load(jpath)), dict(np.load(str(tmp_path / "again.npz"))))


# --- checkpoints ---------------------------------------------------------------

def test_checkpoint_resumes_to_the_same_next_step(tmp_path):
    crops, labels = jpairs.build_pair_crops(2, 2, seed=9300)
    x = crops.astype(np.uint8)
    make = lambda: ArcFaceTrainer(num_classes=2, seed=0, learning_rate=0.05, device="cpu")
    a = make()
    a.train_step(x, labels)
    path = str(tmp_path / "state")
    assert save_checkpoint(path, a.state) == "npz" and os.path.exists(path + ".npz")
    want = a.train_step(x[::-1].copy(), labels[::-1].copy())
    b = make()
    assert load_checkpoint(path, like=b.state) is b.state and b.state["step"] == 1
    got = b.train_step(x[::-1].copy(), labels[::-1].copy())
    assert got == want
    _equal(flatten_params(to_numpy_params(b.state["params"])),
           flatten_params(to_numpy_params(a.state["params"])))
    # AdamW state too (moments and their step count)
    s = SpoofTrainer(seed=0, device="cpu")
    s.train_step(np.full((2, 64, 64, 3), 90.0, np.float32), np.array([0, 1]))
    save_checkpoint(path + "_spoof", s.state)
    s2 = SpoofTrainer(seed=0, device="cpu")
    load_checkpoint(path + "_spoof", like=s2.state)
    for p, q in zip(s.optimizer.param_groups[0]["params"], s2.optimizer.param_groups[0]["params"]):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            _equal(s.optimizer.state[p][key], s2.optimizer.state[q][key])


def test_checkpoint_of_another_config_is_refused(tmp_path):
    a = ArcFaceTrainer(num_classes=3, seed=0, device="cpu")
    path = str(tmp_path / "state")
    save_checkpoint(path, a.state)
    b = ArcFaceTrainer(num_classes=4, seed=0, device="cpu")  # another identity count
    before = b.state["params"]["classifier"].detach().clone()
    seen = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda r: seen.append(r.getMessage())
    logger = logging.getLogger("frp.train.checkpoint")  # the frp root does not propagate
    logger.addHandler(handler)
    try:
        assert load_checkpoint(path, like=b.state) is None
    finally:
        logger.removeHandler(handler)
    assert any("refusing to restore" in m for m in seen)
    assert torch.equal(b.state["params"]["classifier"].detach(), before)
    c = ArcFaceTrainer(num_classes=3, seed=0, arch="iresnet18", device="cpu")  # other names
    assert load_checkpoint(path, like=c.state) is None
    assert load_checkpoint(str(tmp_path / "absent"), like=a.state) is None


# --- the tools -----------------------------------------------------------------

def test_pretrain_embedder_main(tmp_path):
    out, state = str(tmp_path / "emb.npz"), str(tmp_path / "st")
    args = ["--steps", "2", "--batch", "4", "--identities", "3", "--out", out, "--state", state,
            "--margin-warmup", "4", "--difficulty", "0.4,0.3,0.2,0.1", "--device", "cpu"]
    res = pretrain_embedder.main(args)
    assert [h["step"] for h in res["history"]] == [1, 2] and os.path.exists(state + ".npz")
    assert j_flatten_tree(j_load_params(out)).keys() == j_flatten_tree(init_mobilefacenet(0)).keys()
    assert 0 <= res["separation"]["same"] and 0 <= res["separation"]["cross"]
    again = pretrain_embedder.main(args[:-2] + ["--resume", out, "--steps", "1", "--device", "cpu"])
    assert again["history"][-1]["step"] == 3  # the state restored its step
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pretrain_embedder.main(["--steps", "1", "--out", out])


def test_pretrain_spoof_and_synthetic_main(tmp_path):
    res = pretrain_spoof.main(["--steps", "1", "--batch", "2", "--out", str(tmp_path / "s.npz"),
                               "--device", "cpu"])
    assert res["history"][0]["step"] == 1 and load_params(str(tmp_path / "s.npz"))["blocks"][0]["expand"] is None
    rng = np.random.default_rng(0)
    crop = jsyn.make_identity_crop(jsyn.make_identity(0), rng)
    from tools import pretrain_spoof as j_spoof_tool

    _equal(pretrain_spoof.replay_artifacts(crop, np.random.default_rng(1)),
           j_spoof_tool.replay_artifacts(crop, np.random.default_rng(1)))
    _equal(pretrain_spoof.resample(crop, np.random.default_rng(2)),
           j_spoof_tool.resample(crop, np.random.default_rng(2)))
    res = pretrain_synthetic.main(["--steps", "1", "--batch", "2", "--det-size", "64",
                                   "--out", str(tmp_path / "d.npz"), "--device", "cpu"])
    assert set(res["history"][0]) >= {"loss", "cls_loss", "loc_loss", "ldm_loss", "step"}
    assert load_params(str(tmp_path / "d.npz"))["stem"]["conv"]["w"].shape == (3, 3, 3, 8)


def test_fl_client_uploads_weights_delta_and_aggregates(monkeypatch, tmp_path):
    """Two clients' uploads, in the JAX package's names, through the port's
    FedAvg service: the aggregate is the numpy mean bit for bit."""
    from frp_tpu_torch.platform.federated import FederatedService

    svc = FederatedService(weights_dir=str(tmp_path / "fl"))
    posted = []

    def post(url, payload):
        posted.append(url)
        if url.endswith("/face/fl/upload_weights"):
            weights = json.loads(json.dumps(payload["weights"]))  # the wire's round trip
            return svc.upload_weights(payload["client_id"], weights)
        return svc.aggregate(None, False, None)

    monkeypatch.setattr(fl_client, "post_json", post)
    runs = [fl_client.main(["--client-id", c, "--steps", "1", "--identities", "2", "--batch", "2",
                            "--seed", str(s), "--device", "cpu"] + (["--aggregate"] if c == "b" else []))
            for s, c in ((1, "a"), (2, "b"))]
    assert posted == ["http://localhost:8000/face/fl/upload_weights"] * 2 + [
        "http://localhost:8000/face/fl/aggregate"]
    names = set(j_flatten_tree(init_mobilefacenet(0)))
    assert set(runs[0]["delta"]) == set(runs[1]["delta"]) == names
    glob = svc.get_weights(runs[1]["aggregate"]["global_model"])
    for k in names:
        want = np.asarray(runs[0]["delta"][k], np.float64) * 0.5 + np.asarray(runs[1]["delta"][k], np.float64) * 0.5
        np.testing.assert_array_equal(np.asarray(glob[k]), want, err_msg=k)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fl_client.main(["--client-id", "c", "--steps", "1"])
