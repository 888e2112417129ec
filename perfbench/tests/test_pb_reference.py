"""The reference's networks and pipeline against the program's at small
size on the CPU, in float32. The tests may import both; the reference
itself imports nothing of the program (test_pb_imports.py)."""

import json
import os

import numpy as np
import pytest
import torch

from frp_tpu_torch.models.iresnet import init_iresnet, iresnet_forward
from frp_tpu_torch.models.mobilefacenet import init_mobilefacenet, mobilefacenet_forward
from frp_tpu_torch.models.mobilenetv3 import init_mobilenetv3_small, mobilenetv3_forward
from frp_tpu_torch.models.params import convert_params, save_params
from frp_tpu_torch.models.retinaface import init_retinaface, retinaface_forward
from perfbench.reference import nets
from perfbench.reference.pipeline import load_npz

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _both(tmp_path, tree):
    path = str(tmp_path / "w.npz")
    save_params(path, tree)
    return convert_params(tree, "cpu"), load_npz(path, "cpu")


@pytest.mark.parametrize("act", ["leaky", "prelu"])
def test_retinaface(tmp_path, act):
    prog, ref = _both(tmp_path, init_retinaface(3, act=act))
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    want = retinaface_forward(prog, x)
    loc, ldm, score = nets.retinaface(ref, x)
    for got, key in ((loc, "loc"), (ldm, "ldm"), (score, "score")):
        torch.testing.assert_close(got, want[key], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["mobilefacenet", "iresnet18", "iresnet50"])
def test_embedders(tmp_path, arch):
    if arch == "mobilefacenet":
        tree, fwd = init_mobilefacenet(4, embed_dim=128), mobilefacenet_forward
    else:
        tree, fwd = init_iresnet(4, variant=arch, embed_dim=512), iresnet_forward
    prog, ref = _both(tmp_path, tree)
    x = torch.randn(2, 112, 112, 3, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(nets.EMBEDDERS[arch](ref, x), fwd(prog, x), rtol=1e-4, atol=1e-5)


def test_spoof_net(tmp_path):
    prog, ref = _both(tmp_path, init_mobilenetv3_small(5, num_classes=2))
    x = torch.randn(3, 112, 112, 3, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(nets.mobilenetv3(ref, x), mobilenetv3_forward(prog, x),
                               rtol=1e-4, atol=1e-4)


def test_pipeline_against_the_engine_in_float32():
    """One 1080p camera of the stream scene through the program's engine on
    the CPU at float32 and through the reference: the same faces, boxes and
    distances to rounding."""
    from perfbench.check import compare, landmarks
    from perfbench.reference.pipeline import Reference, letterbox_i420
    from perfbench.scene import Scene, gallery
    from perfbench.stream import build_engine

    with open(os.path.join(ROOT, "perfbench/traffic/stream.json")) as f:
        scene = Scene(np.random.default_rng(5), dict(json.load(f)["scene"], cameras=1))
    scene.advance()
    with open(os.path.join(ROOT, "perfbench/configs/iresnet50-512.json")) as f:
        cfg = dict(json.load(f), compute_dtype="float32", embedder_arch="mobilefacenet",
                   embed_dim=128, distance_scale=0.665931)
    cfg["weights"] = dict(cfg["weights"], embedder="mobilefacenet.npz")
    wdir = os.path.join(ROOT, "weights")
    yuv = letterbox_i420(scene.cams[0], 640, 368)[None]
    gal = gallery(np.random.default_rng(1), 100, 128)
    eng = build_engine(cfg, 1, wdir, "cpu")
    for i, g in enumerate(gal):
        eng.gallery.add(f"e{i}", g)
    out = eng.fetch(eng.submit_encoded(("raw", yuv)))
    ref = Reference(cfg, wdir, "cpu").faces(yuv, gal, landmarks(out))
    got = compare([out], [ref], cfg)
    assert got["faces"] == 12 == int(out["count"].sum())
    assert got["answers_off"] == 0 and got["idx_gap_max"] == 0.0
    assert got["box_max"] < 1e-3 and got["ldm_max"] < 1e-3
    assert got["score_max"] < 1e-5 and got["fake_max"] < 1e-3
    assert got["dist_max"] < 1e-5


def _face(box, distances, fake=0.1):
    return {"boxes": np.array([box], float), "landmarks": np.zeros((1, 10)),
            "scores": np.array([0.99]), "fake_prob": np.array([fake]),
            "distances": np.array([distances], float)}


@pytest.mark.parametrize("judged_distances,off", [([0.70, 0.50], 0), ([0.50, 0.70], 1)])
def test_a_pick_is_judged_on_the_programs_own_crop(judged_distances, off):
    """The reference's own crop finds entry 0 nearest; the program picked
    entry 1, 0.2 farther there. The pick is judged by the distances of the
    crop cut at the program's landmarks: sound where entry 1 is nearest
    there, one answer off where it is not."""
    from perfbench.check import compare

    cfg = {"conf_thresh": 0.5, "tolerance": 0.6}
    prog = {"boxes": [[[10, 10, 50, 50]]], "landmarks": [[[0.0] * 10]], "scores": [[0.99]],
            "valid": [[True]], "best_idx": [[1]], "best_distance": [[judged_distances[1]]],
            "is_match": [[judged_distances[1] <= 0.6]], "fake_prob": [[0.1]]}
    ref = _face([10, 10, 50, 50], [0.50, 0.70])
    ref["judged"] = {"fake_prob": np.array([0.1]), "distances": np.array([judged_distances])}
    got = compare([prog], [[ref]], cfg)
    assert got["answers_off"] == off, got["why"]
    assert got["dist_max"] == pytest.approx(0.0)


def test_the_judged_crops_at_the_references_own_landmarks_are_its_own():
    from perfbench.reference.pipeline import Reference, letterbox_i420
    from perfbench.scene import Scene, gallery

    with open(os.path.join(ROOT, "perfbench/traffic/stream.json")) as f:
        scene = Scene(np.random.default_rng(7), dict(json.load(f)["scene"], cameras=1))
    with open(os.path.join(ROOT, "perfbench/configs/iresnet50-512.json")) as f:
        cfg = dict(json.load(f), embedder_arch="mobilefacenet", embed_dim=128)
    cfg["weights"] = dict(cfg["weights"], embedder="mobilefacenet.npz")
    ref = Reference(cfg, os.path.join(ROOT, "weights"), "cpu")
    yuv = letterbox_i420(scene.cams[0], 640, 368)[None]
    gal = gallery(np.random.default_rng(2), 20, 128)
    own = ref.faces(yuv, gal)
    got = ref.faces(yuv, gal, [own[0]["landmarks"]])[0]
    assert len(own[0]["scores"]) == 11  # the static faces: no walker before a tick
    np.testing.assert_array_equal(got["judged"]["distances"], own[0]["distances"])
    np.testing.assert_array_equal(got["judged"]["fake_prob"], own[0]["fake_prob"])
