"""The route by which a configuration's embedder arrives as one new file
under ``perfbench/reference/embedders/``: a toy module's seeded weights,
its reference forward and its FLOPs, the refusals, and pins that
``r50.stream``'s iresnet50-512 reads what it read before the route (its
FLOP integers and seeded file measured on the commit before it)."""

import hashlib
import os
import re

import numpy as np
import pytest
import torch

from perfbench import common, flops, weights
from perfbench.reference import embedders, nets
from perfbench.reference.pipeline import Reference, load_npz

ROOT = common.ROOT
SEED = 2**40 + 7
IN = 112 * 112 * 3

# flops.per_frame_and_face of iresnet50-512 at the stream's 100 gallery
# entries, and the sha256 of the iresnet18-512 file seeded from SEED on the
# CPU and of iresnet50-512's leaves, all measured before the route
R50_FLOPS = (1962291200, 12650635408)
R18_SEEDED_SHA256 = "8d313f0d804b7314827994bd8e0e7afefac5cb71e931c6dfd7088c80f97c32a3"
R50_LEAVES_SHA256 = "592d47d97263ca435dfda5dd1f7f48d36ccc4c6a54d7474d7dc168f4b1c737ed"

TOY = '''"""One dense layer to the embedding and an l2 normalisation."""
import torch

ARCHS = ("toy",)


def forward(p, x, q=lambda t: t):
    y = q(x.reshape(x.shape[0], -1)) @ q(p["fc"]["w"])
    return y / y.norm(dim=1, keepdim=True)


def leaves(arch, embed_dim):
    return {"fc/w": ((112 * 112 * 3, embed_dim), "dense")}
'''


def _config(arch="toy", dim=8):
    cfg = common.load_json(os.path.join(ROOT, "perfbench/configs/iresnet50-512.json"))
    cfg.update(name=f"{arch}-{dim}", embedder_arch=arch, embed_dim=dim)
    cfg["weights"] = dict(cfg["weights"], embedder=f"{arch}.npz")
    cfg["seeded"] = {f"{arch}.npz": {"arch": arch, "embed_dim": dim}}
    return cfg


@pytest.fixture
def route(tmp_path, monkeypatch):
    d = tmp_path / "embedders"
    d.mkdir()
    (d / "toy.py").write_text(TOY)
    (d / "_helper.py").write_text("raise RuntimeError('a helper is never loaded')\n")
    monkeypatch.setattr(embedders, "DIR", str(d))
    return d


def test_a_new_file_brings_weights_reference_and_flops(route):
    wdir = common.prepare_weights(_config(), SEED, "cpu")
    with np.load(os.path.join(wdir, "toy.npz")) as f:
        assert f.files == ["fc/w"]
        w = f["fc/w"]
    assert w.shape == (IN, 8)
    np.testing.assert_array_equal(w, weights.draw({"fc/w": ((IN, 8), "dense")}, SEED, "cpu")["fc/w"])

    crop = torch.rand(3, 112, 112, 3, generator=torch.Generator().manual_seed(3)) * 255
    x = (crop - 127.5) / 128.0
    want = x.reshape(3, -1) @ torch.from_numpy(w)
    want = want / want.norm(dim=1, keepdim=True)
    ref = Reference(_config(), wdir, "cpu")
    got = ref.embed_fn(ref.emb, x, ref.q)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    ctl = Reference(_config(), wdir, "cpu", "fp8")
    assert not torch.equal(ctl.embed_fn(ctl.emb, x, ctl.q), got)  # the control's rounding reaches it

    meta = torch.device("meta")
    spoof = load_npz(os.path.join(wdir, "spoof.npz"), meta)
    spoof_flops = flops._count(lambda: nets.mobilenetv3(spoof, torch.zeros((1, 112, 112, 3),
                                                                           device=meta)))
    f_det, f_face = flops.per_frame_and_face(_config(), wdir, 100)
    assert f_det == R50_FLOPS[0]
    assert f_face == 2 * IN * 8 + spoof_flops + 2 * 8 * 100


@pytest.mark.parametrize("case", ["unknown", "claimed_twice", "odd_kind", "no_leaves"])
def test_the_route_refuses(route, case):
    arch, where = "toy", str(route)
    if case == "unknown":
        arch = "vit_l"
    elif case == "claimed_twice":
        (route / "toy_copy.py").write_text(TOY)
    elif case == "odd_kind":
        (route / "toy.py").write_text(TOY.replace('"dense"', '"dens"'))
        where = "fc/w"
    else:
        arch, where = "mobilefacenet", "mobilefacenet"
    with pytest.raises(SystemExit, match=re.escape(where)):
        weights.write_seeded(str(route / "w.npz"), {"arch": arch, "embed_dim": 8}, SEED, "cpu")
    if case in ("unknown", "claimed_twice"):
        with pytest.raises(SystemExit, match=f"{arch}.*{re.escape(where)}"):
            embedders.resolve(arch)


# -- r50.stream reads what it read before the route ---------------------------


def test_nets_serve_their_archs_without_loading_a_file(route):
    (route / "greedy.py").write_text("raise RuntimeError('loaded')\n")
    for arch in nets.EMBEDDERS:
        got = embedders.resolve(arch)
        assert got.forward is nets.EMBEDDERS[arch]
        assert got.leaves is (weights.iresnet_leaves if arch in nets.IRESNET_DEPTHS else None)
    assert embedders.resolve("iresnet50").forward is nets.iresnet


def test_iresnet50_512_flops_and_seeded_bytes_are_the_parents(tmp_path):
    cfg = common.load_json(os.path.join(ROOT, "perfbench/configs/iresnet50-512.json"))
    wdir = common.prepare_weights(cfg, SEED, "cpu")
    assert flops.per_frame_and_face(cfg, wdir, 100) == R50_FLOPS
    weights.write_seeded(str(tmp_path / "r18.npz"), {"arch": "iresnet18", "embed_dim": 512},
                         SEED, "cpu")
    assert common.sha256(str(tmp_path / "r18.npz")) == R18_SEEDED_SHA256
    leaves = weights.iresnet_leaves("iresnet50", 512)
    lines = "\n".join(f"{k} {leaves[k][0]} {leaves[k][1]}" for k in sorted(leaves))
    assert hashlib.sha256(lines.encode()).hexdigest() == R50_LEAVES_SHA256
