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
    from perfbench.check import compare
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
    ref = Reference(cfg, wdir, "cpu").faces(yuv, gal)
    eng = build_engine(cfg, 1, wdir, "cpu")
    for i, g in enumerate(gal):
        eng.gallery.add(f"e{i}", g)
    out = eng.fetch(eng.submit_encoded(("raw", yuv)))
    got = compare([out], [ref], cfg)
    assert got["faces"] == 12 == int(out["count"].sum())
    assert got["answers_off"] == 0 and got["idx_gap_max"] == 0.0
    assert got["box_max"] < 1e-3 and got["ldm_max"] < 1e-3
    assert got["score_max"] < 1e-5 and got["fake_max"] < 1e-3
    assert got["dist_max"] < 1e-5
