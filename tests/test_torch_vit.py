"""PyTorch port, InsightFace's ViT face embedder (``models/vit.py``) against
the plain float32 reference ``tests/vit_reference.py`` on seeded random
weights, at a small size on the CPU: width 96, depth 2, 2 heads of 48, MLP
384, 9x9 patches of 112 x 112 crops, 64-d.

The weights are drawn as the benchmark draws its seeded files, with larger
biases: biases, pos_embed, LN betas and BN means N(0, 0.2), LN gammas and
BN variances U(0.8, 1.2), and the blocks' fc1 weights at three times their
He scale, so that about a tenth of the hidden units pass ReLU6's clip at 6.

Tolerances, on the euclidean distance between the port's and the
reference's unit embeddings of a face (what the gallery's distances see):

* float32: 1e-5 (the two sum in different orders; measured <= 3e-7);
* bfloat16 (``BF16_TOL``): an embedding meets about 26 roundings to
  bfloat16 on its way (the input; the patch GEMM and the pos_embed add;
  in each block LN1, qkv, attention, proj, the add, LN2, fc1, fc2 and the
  add; the final LN's output, both head linears), each moving it by a
  uniform relative error of RMS 2**-8 / sqrt(3); independent, they add in
  quadrature to sqrt(26 / 3) * 2**-8 = 0.0115, the RMS expected, and the
  tolerance is twice that, 0.023 (measured 0.0106-0.0120 over 8 seeds of
  8 crops). Dropping any one bias, the pos_embed, the 108-pixel cut, the
  final LN or ReLU6's clip moves the embeddings by 0.060 or more
  (``test_bf16_tolerance_catches_each_omission``). A final LN in bfloat16
  in place of float32 differs only by the rounding of its gamma and beta,
  which the bfloat16 head linear's input rounding matches, so no tolerance
  on the embeddings tells the two apart:
  ``test_final_layer_norm_runs_in_float32`` holds the dtype itself.
"""

import functools
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from frp_tpu_torch.config import load_config
from frp_tpu_torch.engine import pipeline
from frp_tpu_torch.engine.pipeline import EMBEDDER_ARCHS, RecognitionEngine, build_stages
from frp_tpu_torch.models import vit
from frp_tpu_torch.models.params import (
    _unflatten,
    convert_params,
    flatten_params,
    save_params,
)
from frp_tpu_torch.ops.image import normalize_face
from frp_tpu_torch.testing.synthetic import make_scene
from frp_tpu_torch.utils import profiling
from tests import vit_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(width=96, depth=2, heads=2, mlp=384, patch=9)
DIM = 64
F32_TOL = 1e-5
BF16_TOL = 2 * np.sqrt(26 / 3) * 2.0 ** -8


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs its files in parallel worker processes: two intra-op
    threads a test keep those from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _weights(seed: int, sizes=SMALL, dim=DIM) -> dict:
    """A small ViT tree of seeded random weights (the module's docstring)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flatten_params(vit.init_vit(rng, embed_dim=dim, **sizes)).items():
        last = k.rsplit("/", 1)[-1]
        if last in ("gamma", "var"):
            v = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        elif last in ("beta", "b", "mean", "pos_embed"):
            v = rng.normal(0.0, 0.2, v.shape).astype(np.float32)
        elif k.startswith("blocks/") and k.endswith("fc1/w"):
            v = v * 3.0
        out[k] = v
    return _unflatten(out)


def _crops(seed: int, n: int = 8) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return normalize_face(torch.rand(n, 112, 112, 3, generator=g) * 255.0)


def _port(tree, x, dtype=torch.float32):
    return vit.vit_forward(convert_params(tree), x.to(dtype), heads=SMALL["heads"])


def _ref(tree, x):
    return vit_reference.forward(tree, x, heads=SMALL["heads"])


def _dist(a, b) -> float:
    return float((a - b).norm(dim=1).max())


def test_init_tree_and_unknown_variant():
    tree = flatten_params(vit.init_vit(0, embed_dim=DIM, **SMALL))
    assert tree["patch_embed/w"].shape == (9, 9, 3, 96)
    assert tree["pos_embed"].shape == (144, 96)
    assert tree["blocks/1/qkv/w"].shape == (96, 288)
    assert "blocks/0/qkv/b" not in tree and "head/fc1/b" not in tree
    assert tree["head/fc1/w"].shape == (144 * 96, 96)
    assert tree["head/fc2/w"].shape == (96, DIM)
    with pytest.raises(ValueError, match="unknown variant"):
        vit.init_vit(0, variant="vit_h")


@pytest.mark.parametrize("seed", [0, 1])
def test_f32_equals_reference(seed):
    tree, x = _weights(seed), _crops(seed)
    got, want = _port(tree, x), _ref(tree, x)
    assert got.dtype == torch.float32 and got.shape == (8, DIM)
    assert _dist(got, want) <= F32_TOL


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bf16_within_derived_tolerance(seed):
    tree, x = _weights(seed), _crops(seed)
    got = _port(tree, x, torch.bfloat16)
    assert got.dtype == torch.float32
    assert _dist(got, _ref(tree, x)) <= BF16_TOL


def _zero(tree, suffix):
    flat = flatten_params(tree)
    return _unflatten({k: np.zeros_like(v) if k.endswith(suffix) else v for k, v in flat.items()})


OMISSIONS = ["patch_embed/b", "proj/b", "fc1/b", "fc2/b", "pos_embed", "cut", "final_ln", "relu6"]


@pytest.mark.parametrize("omission", OMISSIONS)
def test_bf16_tolerance_catches_each_omission(monkeypatch, omission):
    """Each part left out of the port's bfloat16 forward moves the
    embeddings past ``BF16_TOL`` on the same weights and crops."""
    tree, x = _weights(0), _crops(0)
    want = _ref(tree, x)
    prog = tree
    if omission == "cut":  # the last 108 rows and columns in place of the first
        patchify = vit.patchify
        monkeypatch.setattr(vit, "patchify",
                            lambda t, p: patchify(F.pad(t[:, 4:, 4:], (0, 0, 0, 4, 0, 4)), p))
    elif omission == "final_ln":
        layer_norm = vit.nn.layer_norm
        monkeypatch.setattr(vit.nn, "layer_norm", lambda p, t, eps=1e-5: (
            t if t.dtype == torch.float32 else layer_norm(p, t, eps)))
    elif omission == "relu6":
        monkeypatch.setattr(vit.F, "relu6", lambda t, inplace=False: F.relu(t))
    else:
        prog = _zero(tree, omission)
    assert _dist(_port(prog, x, torch.bfloat16), want) > BF16_TOL


def test_final_layer_norm_runs_in_float32(monkeypatch):
    """The blocks' LNs run in the compute dtype, the final one on a float32
    input with float32 gamma and beta."""
    seen = []
    layer_norm = F.layer_norm

    def spy(t, shape, weight=None, bias=None, eps=1e-5):
        seen.append((t.dtype, weight.dtype, bias.dtype, eps))
        return layer_norm(t, shape, weight, bias, eps)

    monkeypatch.setattr(vit.nn.F, "layer_norm", spy)
    _port(_weights(0), _crops(0, 2), torch.bfloat16)
    bf = torch.bfloat16
    assert seen == [(bf, bf, bf, 1e-5)] * 2 * SMALL["depth"] + [(torch.float32,) * 3 + (1e-5,)]


@pytest.mark.parametrize("rung", ["count", None])
def test_embed_stage_equals_reference(monkeypatch, rung):
    """The engine's embed stage with the ViT's forward: at the compaction
    rung its valid count picks (32 of 64 slots) and whole, the reference's
    embeddings on the valid slots, zeros on the others."""
    monkeypatch.delenv("FRP_EMBED_COMPACT", raising=False)
    monkeypatch.delenv("FRP_EMBED_RUNGS", raising=False)
    stages = build_stages(device="cpu", det_size=128, compute_dtype="float32", with_spoof=False,
                          embedder_forward=functools.partial(vit.vit_forward,
                                                             heads=SMALL["heads"]))
    assert stages["rungs"](64) == [8, 32, 52]
    tree = _weights(3)
    g = torch.Generator().manual_seed(4)
    crops = torch.rand(16, 4, 112, 112, 3, generator=g) * 255.0
    valid = torch.zeros(64, dtype=torch.bool)
    valid[torch.randperm(64, generator=g)[:20]] = True
    valid = valid.reshape(16, 4)
    out = stages["embed"]({"embedder": convert_params(tree)}, crops, valid, rung=rung)
    got = out["embeddings_flat"]
    v = valid.reshape(-1)
    want = _ref(tree, normalize_face(crops.reshape(64, 112, 112, 3)[v]))
    assert _dist(got[v], want) <= F32_TOL
    assert not got[~v].any()


def test_engine_builds_and_loads_vit_l(monkeypatch, tmp_path):
    """``embedder_arch="vit_l"`` (its sizes cut for the CPU) through
    RecognitionEngine: ``vit_l.npz`` loaded by ``_load_weights``, and two
    batches, the second at a speculated rung, whose valid slots carry the
    reference's embeddings of the engine's own crops. ``EMBEDDERS``' entry
    is patched with the variant, as the table binds each ViT's head count
    when it is built."""
    monkeypatch.setitem(vit.VIT_VARIANTS, "vit_l", SMALL)
    monkeypatch.setitem(pipeline.EMBEDDERS, "vit_l",
                        (vit.init_vit, functools.partial(vit.vit_forward, heads=SMALL["heads"])))
    monkeypatch.delenv("FRP_EMBED_COMPACT", raising=False)
    monkeypatch.delenv("FRP_EMBED_RUNGS", raising=False)
    for name in ("retinaface_synthetic.npz", "spoof.npz"):
        os.symlink(os.path.join(REPO, "weights", name), tmp_path / name)
    tree = _weights(5)
    save_params(str(tmp_path / "vit_l.npz"), tree)
    cfg = load_config(det_size=128, max_faces_per_frame=4, pre_nms_topk=64,
                      det_conf_threshold=0.3, compute_dtype="float32", embedder_arch="vit_l",
                      embed_dim=DIM, weights_dir=str(tmp_path))
    eng = RecognitionEngine(cfg, device="cpu")
    assert eng.weights_loaded["embedder"] == str(tmp_path / "vit_l.npz")
    assert eng._embedder_forward.keywords == {"heads": SMALL["heads"]}
    frames = np.stack([make_scene(128, np.random.default_rng(60 + i), max_faces=2)[0]
                       for i in range(16)])
    ft = torch.from_numpy(frames)
    dets = eng._stages["detect"](eng.params["detector"], ft, eng._priors)
    crops = eng._stages["crop"](ft, dets)["crops"]
    v = dets["valid"].reshape(-1)
    assert int(v.sum()) > 0
    want = _ref(tree, normalize_face(crops.reshape(-1, 112, 112, 3)[v]))
    for _ in range(2):
        out = eng.process_frames(frames)
        got = torch.from_numpy(out["embeddings"]).reshape(64, DIM)
        assert np.array_equal(out["valid"].reshape(-1), v.numpy())
        assert _dist(got[v], want) <= F32_TOL
    assert eng.embed_stats["whole"] == 1 and eng.embed_stats["speculated"] == 1


def test_unknown_embedder_arch_raises():
    with pytest.raises(ValueError, match="vit_b.*mobilefacenet.*iresnet50.*vit_l"):
        RecognitionEngine(load_config(embedder_arch="vit_b", det_size=128), device="cpu")
    assert EMBEDDER_ARCHS == ("mobilefacenet", "iresnet18", "iresnet34", "iresnet50",
                              "iresnet100", "vit_l", "swin_t")


def test_the_embedder_table_binds_each_vits_head_count():
    """``EMBEDDERS`` is the one place the engine reads an arch from: a ViT's
    forward there carries its variant's head count."""
    for arch, v in vit.VIT_VARIANTS.items():
        init, forward = pipeline.EMBEDDERS[arch]
        assert init is vit.init_vit and forward.func is vit.vit_forward
        assert forward.keywords == {"heads": v["heads"]}


def test_no_span_without_a_profiler(monkeypatch):
    """Untraced, ``span`` makes no range at all."""
    made = []
    monkeypatch.setattr(profiling, "_RANGE", lambda name: made.append(name))
    _port(_weights(0), _crops(0, 2))
    assert made == []


def test_spans_once_a_block_under_a_profiler():
    """Each block opens ``frp.vit.attn``, ``frp.vit.sdpa`` nested in it and
    ``frp.vit.mlp`` once."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _port(_weights(0), _crops(0, 2))
    events = [e for e in prof.events() if e.name.startswith("frp.vit.")]
    names = [e.name for e in events]
    for name in ("frp.vit.attn", "frp.vit.sdpa", "frp.vit.mlp"):
        assert names.count(name) == SMALL["depth"]
    assert len(names) == 3 * SMALL["depth"]
    for e in events:
        if e.name == "frp.vit.sdpa":
            assert e.cpu_parent is not None and e.cpu_parent.name == "frp.vit.attn"


# -- the benchmark's reference copy ------------------------------------------


def _bench_embedder():
    from perfbench.reference.embedders import resolve

    return resolve("vit_l")


def test_bench_reference_equals_the_test_reference(tmp_path):
    """``perfbench/reference/embedders/vit.py`` on a small tree read back
    from a weights file as the harness reads it (its head count, 8, at
    width 96) equals ``tests/vit_reference.py``."""
    from perfbench.reference.pipeline import load_npz

    sizes = dict(SMALL, heads=8)
    tree = _weights(6, sizes)
    save_params(str(tmp_path / "v.npz"), tree)
    x = _crops(6, 4)
    got = _bench_embedder().forward(load_npz(str(tmp_path / "v.npz"), "cpu"), x)
    want = vit_reference.forward(tree, x, heads=8)
    assert _dist(got, want) <= F32_TOL
    prog = vit.vit_forward(convert_params(tree), x, heads=8)
    assert _dist(prog, want) <= F32_TOL


def test_bench_leaves_equal_init_vit():
    leaves = _bench_embedder().leaves("vit_l", 512)
    tree = flatten_params(vit.init_vit(0, "vit_l", 512))
    assert {k: tuple(v.shape) for k, v in tree.items()} == {k: s for k, (s, _) in leaves.items()}
    kinds = {kind for _, kind in leaves.values()}
    assert "zero" not in kinds and kinds <= {"conv", "dense", "gamma", "beta", "mean", "var"}
    assert sum(int(np.prod(s)) for s, _ in leaves.values()) == 255_686_144


def _meta_tree(leaves: dict) -> dict:
    flat = {k: torch.empty(s, device="meta") for k, (s, _) in leaves.items()}
    return _unflatten(flat)


def test_bench_reference_counts_and_rounds_every_matmul():
    """On meta tensors at the published widths one face is 50.68 GFLOP
    (patch conv, the blocks' linears and attention, the head), and ``q``
    meets both operands of each of those matmuls."""
    emb = _bench_embedder()
    p = _meta_tree(emb.leaves("vit_l", 512))
    x = torch.empty((1, 112, 112, 3), device="meta")
    calls = []

    def q(t):
        calls.append(tuple(t.shape))
        return t

    with FlopCounterMode(display=False) as fc:
        y = emb.forward(p, x, q)
    t, w = 144, 768
    block = 2 * t * (w * 3 * w + w * w + 2 * w * 4 * w) + 2 * 2 * 8 * t * t * 96
    want = 2 * t * 243 * w + 24 * block + 2 * t * w * w + 2 * w * 512
    assert fc.get_total_flops() == want == 50_675_589_120
    assert tuple(y.shape) == (1, 512)
    assert len(calls) == 2 + 24 * 12 + 4
    assert calls[:2] == [(1, 3, 112, 112), (768, 3, 9, 9)]
    assert calls[4:8] == [(1, 8, t, 96), (1, 8, t, 96), (1, 8, t, t), (1, 8, t, 96)]
