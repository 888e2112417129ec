"""PyTorch port, SwinFace's Swin-T face embedder (``models/swin.py``) against
the plain float32 reference ``tests/swin_reference.py`` on seeded random
weights, at a small size on the CPU: patch 2 at 112 x 112, width 16,
depths 2-2-2-2, heads 1-2-4-8 (16 wide), window 7, 64-d. Shifted blocks
then run in stages 1-3 (grids 56, 28 and 14), and stage 4 (grid 7, one
window) has none.

The weights are drawn as the benchmark draws its seeded files, with larger
tables: biases, LN betas and BN means N(0, 0.2), LN gammas and BN
variances U(0.8, 1.2), the relative-position tables N(0, 2) (100 times the
init's scale, so that the bias moves the attention), and stage 4's qkv
weights at twice their He scale. The crops are a smooth field (7 x 7
uniform values upsampled bilinearly, 0.9 of the range) plus 0.1 of
uniform noise: on noise alone the 49 tokens of stage 4 come out nearly
equal, and any attention pattern in its one window then pools to the same
token.

Tolerances, on the euclidean distance between the port's and the
reference's unit embeddings of a face (what the gallery's distances see):

* float32: 1e-5 (the two sum in different orders; measured <= 1.3e-6);
* bfloat16 (``BF16_TOL``): an embedding meets about 101 roundings to
  bfloat16 on its way (the input; the patch GEMM and its LN; in each of the
  8 blocks LN1, qkv, the bias with its mask, the attention, proj, the add,
  LN2, fc1, GELU, fc2 and the add; each merge's LN and linear; the final
  LN's output, the pooled token, both head linears), each moving it by a
  uniform relative error of RMS 2**-8 / sqrt(3); independent, they add in
  quadrature to sqrt(101 / 3) * 2**-8 = 0.0227, the RMS expected, and the
  tolerance is twice that, 0.0453 (measured 0.0073-0.0295 over 12 seeds of
  8 crops). Each omission of ``OMISSIONS`` moves seed 2's embeddings by
  0.10 or more (``test_bf16_tolerance_catches_each_omission``): a shift in
  stage 4 by 0.100, the shift mask by 0.27, the relative-position bias by
  0.38, merging's x1 and x2 swapped by 0.41, the roll by 0.48, ReLU for
  GELU by 0.17. Over 12 seeds a stage-4 shift moves them by 0.018-0.163:
  the least visible of the six, as the pooled token averages the window.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from frp_tpu_torch.config import load_config
from frp_tpu_torch.engine.pipeline import EMBEDDER_ARCHS, RecognitionEngine, build_stages
from frp_tpu_torch.models import swin
from frp_tpu_torch.models.params import (
    _unflatten,
    convert_params,
    flatten_params,
    save_params,
)
from frp_tpu_torch.ops.image import normalize_face
from frp_tpu_torch.testing.synthetic import make_scene
from frp_tpu_torch.utils import profiling
from tests import swin_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(width=16, depths=(2, 2, 2, 2), heads=(1, 2, 4, 8))
DIM = 64
F32_TOL = 1e-5
BF16_TOL = 2 * np.sqrt(101 / 3) * 2.0 ** -8


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs its files in parallel worker processes: two intra-op
    threads a test keep those from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _weights(seed: int, sizes=SMALL, dim=DIM) -> dict:
    """A small Swin tree of seeded random weights (the module's docstring)."""
    rng = np.random.default_rng(seed)
    out = {}
    last_stage = f"stages/{len(sizes['depths']) - 1}/"
    for k, v in flatten_params(swin.init_swin(rng, embed_dim=dim, **sizes)).items():
        last = k.rsplit("/", 1)[-1]
        if last in ("gamma", "var"):
            v = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        elif last in ("beta", "b", "mean"):
            v = rng.normal(0.0, 0.2, v.shape).astype(np.float32)
        elif last == "rel_bias":
            v = rng.normal(0.0, 2.0, v.shape).astype(np.float32)
        elif k.startswith(last_stage) and k.endswith("qkv/w"):
            v = v * 2.0
        out[k] = v
    return _unflatten(out)


def _crops(seed: int, n: int = 8) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    field = F.interpolate(torch.rand(n, 3, 7, 7, generator=g), size=(112, 112), mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1)
    return normalize_face((0.9 * field + 0.1 * torch.rand(n, 112, 112, 3, generator=g)) * 255.0)


def _port(tree, x, dtype=torch.float32):
    return swin.swin_forward(convert_params(tree), x.to(dtype))


def _dist(a, b) -> float:
    return float((a - b).norm(dim=1).max())


def test_init_tree_and_unknown_variant():
    tree = flatten_params(swin.init_swin(0, embed_dim=DIM, **SMALL))
    assert tree["patch_embed/w"].shape == (2, 2, 3, 16)
    assert tree["stages/0/blocks/1/qkv/w"].shape == (16, 48)
    assert tree["stages/2/blocks/0/rel_bias"].shape == (169, 4)
    assert tree["stages/1/merge/reduction/w"].shape == (128, 64)
    assert "stages/3/merge/norm/gamma" not in tree and "head/fc1/b" not in tree
    assert tree["head/fc1/w"].shape == (128, 128)
    assert tree["head/fc2/w"].shape == (128, DIM)
    with pytest.raises(ValueError, match="unknown variant"):
        swin.init_swin(0, variant="swin_b")


def test_shift_mask_and_relative_index_equal_swins():
    """The port's mask (region buckets of the rolled grid) and relative
    index equal the reference's, written as Swin's source writes them."""
    for grid in (56, 28, 14, 7):
        for shift in (0, 3):
            want = (swin_reference.shift_mask(grid, 7, shift) if shift
                    else torch.zeros((grid // 7) ** 2, 49, 49))
            assert torch.equal(swin.shift_mask(grid, shift, 7), want)
    assert torch.equal(swin._rel_index(7), swin_reference.relative_index(7))
    assert [swin.shift_of(g, i, 7) for g in (56, 7) for i in range(4)] == [0, 3, 0, 3, 0, 0, 0, 0]


@pytest.mark.parametrize("seed", [0, 1])
def test_f32_equals_reference(seed):
    tree, x = _weights(seed), _crops(seed)
    got, want = _port(tree, x), swin_reference.forward(tree, x)
    assert got.dtype == torch.float32 and got.shape == (8, DIM)
    assert _dist(got, want) <= F32_TOL


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bf16_within_derived_tolerance(seed):
    tree, x = _weights(seed), _crops(seed)
    got = _port(tree, x, torch.bfloat16)
    assert got.dtype == torch.float32
    assert _dist(got, swin_reference.forward(tree, x)) <= BF16_TOL


OMISSIONS = ["roll", "shift_mask", "rel_bias", "stage4_shift", "merge_order", "gelu"]


@pytest.mark.parametrize("omission", OMISSIONS)
def test_bf16_tolerance_catches_each_omission(monkeypatch, omission):
    """Each part left out of the port's bfloat16 forward moves the
    embeddings past ``BF16_TOL`` on the same weights and crops."""
    tree, x = _weights(2), _crops(2)
    want = swin_reference.forward(tree, x)
    prog = tree
    if omission == "roll":
        rolled = swin.rolled
        monkeypatch.setattr(swin, "rolled", lambda grid, shift: rolled(grid, 0))
    elif omission == "shift_mask":
        shift_mask = swin.shift_mask
        monkeypatch.setattr(swin, "shift_mask", lambda grid, shift, w: shift_mask(grid, 0, w))
    elif omission == "rel_bias":
        flat = flatten_params(tree)
        prog = _unflatten({k: np.zeros_like(v) if k.endswith("rel_bias") else v
                           for k, v in flat.items()})
    elif omission == "stage4_shift":
        monkeypatch.setattr(swin, "shift_of", lambda grid, i, w: (i % 2) * (w // 2))
    elif omission == "merge_order":
        monkeypatch.setattr(swin, "MERGE", ((0, 0), (0, 1), (1, 0), (1, 1)))
    else:
        monkeypatch.setattr(swin.F, "gelu", lambda t, approximate="none": F.relu(t))
    assert _dist(_port(prog, x, torch.bfloat16), want) > BF16_TOL


def test_attention_runs_only_fused_backends_with_the_bias(monkeypatch):
    """Every attention call carries its run's bias, [1, heads, 49, 49] of
    q's dtype over rows padded to 56, under the fused backends alone; with
    the fused backends refused the call raises."""
    seen = []
    sdpa = F.scaled_dot_product_attention

    def spy(q, k, v, attn_mask=None, **kw):
        seen.append((q.shape, attn_mask.shape, attn_mask.dtype, attn_mask.stride()))
        return sdpa(q, k, v, attn_mask=attn_mask, **kw)

    monkeypatch.setattr(swin.F, "scaled_dot_product_attention", spy)
    x = _crops(0, 2).to(torch.bfloat16)
    swin.swin_forward(convert_params(_weights(0)), x)
    # stages 1-3: the even block one run, the odd block four (inside, last
    # column, last row, corner); stage 4: one run each block
    assert len(seen) == 3 * (1 + 4) + 2
    for q, shape, dtype, stride in seen:
        assert shape == (1, q[1], 49, 49) and dtype == torch.bfloat16
        assert stride[2] == 56 and stride[3] == 1
    # stage 1 at 2 faces: 128 windows, then the shifted block's 98, 14, 14, 2
    assert seen[0][0][0] == 128 and sorted(s[0][0] for s in seen[1:5]) == [2, 14, 14, 98]
    monkeypatch.setattr(swin, "BIASED", [torch.nn.attention.SDPBackend.EFFICIENT_ATTENTION])
    with pytest.raises(RuntimeError):
        swin.swin_forward(convert_params(_weights(0)), x)


def test_a_run_past_max_windows_splits_into_calls(monkeypatch):
    """A run of windows longer than ``MAX_WINDOWS`` goes to the attention in
    parts of at most that many windows, each with its run's bias; the
    embeddings are the unsplit forward's."""
    params, x = convert_params(_weights(0)), _crops(0, 2)
    whole = swin.swin_forward(params, x)
    seen = []
    sdpa = F.scaled_dot_product_attention

    def spy(q, k, v, attn_mask=None, **kw):
        seen.append(q.shape[0])
        return sdpa(q, k, v, attn_mask=attn_mask, **kw)

    monkeypatch.setattr(swin, "MAX_WINDOWS", 40)
    monkeypatch.setattr(swin.F, "scaled_dot_product_attention", spy)
    split = swin.swin_forward(params, x)
    assert max(seen) == 40 and seen[:4] == [40, 40, 40, 8]
    assert _dist(split, whole) <= 1e-6


def test_bias_and_gathers_are_built_once():
    """A second forward of the same tree at the same batch size builds no
    bias and no index pattern: each comes from the tree's caches. A forward
    at another batch size adds no entry to them (the gathers' indices of a
    batch are built in the call, from patterns that do not depend on its
    size), and its indices are a permutation and its inverse."""
    params = convert_params(_weights(0))
    x = _crops(0, 3)
    first = swin.swin_forward(params, x[:2])
    cached = {k: v for k, v in params["_cast"].items()}
    biases = [b["_cast"][k] for st in params["stages"] for b in st["blocks"]
              for k in b["_cast"] if k[0] == "swin_bias"]
    assert len(biases) == 8
    again = swin.swin_forward(params, x[:2])
    assert torch.equal(first, again)
    assert all(params["_cast"][k] is v for k, v in cached.items())
    assert [b["_cast"][k] for st in params["stages"] for b in st["blocks"]
            for k in b["_cast"] if k[0] == "swin_bias"] == biases
    three = swin.swin_forward(params, x)
    assert params["_cast"].keys() == cached.keys()
    assert all(params["_cast"][k] is v for k, v in cached.items())
    assert _dist(three[:2], first) <= 1e-6
    for grid, shift in ((56, 3), (28, 0), (14, 3)):
        idx, inv = swin._gather(params["_cast"], 3, grid, shift, 7, x.device)
        rows = torch.arange(3 * grid * grid)
        assert torch.equal(idx.sort().values, rows) and torch.equal(idx[inv], rows)


@pytest.mark.parametrize("rung", ["count", None])
def test_embed_stage_equals_reference(monkeypatch, rung):
    """The engine's embed stage with the Swin's forward: at the compaction
    rung its valid count picks (32 of 64 slots) and whole, the reference's
    embeddings on the valid slots, zeros on the others."""
    monkeypatch.delenv("FRP_EMBED_COMPACT", raising=False)
    monkeypatch.delenv("FRP_EMBED_RUNGS", raising=False)
    stages = build_stages(device="cpu", det_size=128, compute_dtype="float32", with_spoof=False,
                          embedder_forward=swin.swin_forward)
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
    want = swin_reference.forward(tree, normalize_face(crops.reshape(64, 112, 112, 3)[v]))
    assert _dist(got[v], want) <= F32_TOL
    assert not got[~v].any()


def test_engine_builds_and_loads_swin_t(monkeypatch, tmp_path):
    """``embedder_arch="swin_t"`` (its sizes cut for the CPU) through
    RecognitionEngine: ``swin_t.npz`` loaded by ``_load_weights``, and two
    batches, the second at a speculated rung, whose valid slots carry the
    reference's embeddings of the engine's own crops."""
    monkeypatch.setitem(swin.SWIN_VARIANTS, "swin_t", dict(swin.SWIN_VARIANTS["swin_t"], **SMALL))
    monkeypatch.delenv("FRP_EMBED_COMPACT", raising=False)
    monkeypatch.delenv("FRP_EMBED_RUNGS", raising=False)
    for name in ("retinaface_synthetic.npz", "spoof.npz"):
        os.symlink(os.path.join(REPO, "weights", name), tmp_path / name)
    tree = _weights(5)
    save_params(str(tmp_path / "swin_t.npz"), tree)
    cfg = load_config(det_size=128, max_faces_per_frame=4, pre_nms_topk=64,
                      det_conf_threshold=0.3, compute_dtype="float32", embedder_arch="swin_t",
                      embed_dim=DIM, weights_dir=str(tmp_path))
    eng = RecognitionEngine(cfg, device="cpu")
    assert eng.weights_loaded["embedder"] == str(tmp_path / "swin_t.npz")
    assert eng._embedder_forward is swin.swin_forward
    frames = np.stack([make_scene(128, np.random.default_rng(60 + i), max_faces=2)[0]
                       for i in range(16)])
    ft = torch.from_numpy(frames)
    dets = eng._stages["detect"](eng.params["detector"], ft, eng._priors)
    crops = eng._stages["crop"](ft, dets)["crops"]
    v = dets["valid"].reshape(-1)
    assert int(v.sum()) > 0
    want = swin_reference.forward(tree, normalize_face(crops.reshape(-1, 112, 112, 3)[v]))
    for _ in range(2):
        out = eng.process_frames(frames)
        got = torch.from_numpy(out["embeddings"]).reshape(64, DIM)
        assert np.array_equal(out["valid"].reshape(-1), v.numpy())
        assert _dist(got[v], want) <= F32_TOL
    assert eng.embed_stats["whole"] == 1 and eng.embed_stats["speculated"] == 1


def test_arch_table_names_every_embedder():
    assert EMBEDDER_ARCHS == ("mobilefacenet", "iresnet18", "iresnet34", "iresnet50",
                              "iresnet100", "vit_l", "swin_t")
    with pytest.raises(ValueError, match="swin_b.*vit_l.*swin_t"):
        RecognitionEngine(load_config(embedder_arch="swin_b", det_size=128), device="cpu")


def test_no_span_without_a_profiler(monkeypatch):
    """Untraced, ``span`` makes no range at all."""
    made = []
    monkeypatch.setattr(profiling, "_RANGE", lambda name: made.append(name))
    _port(_weights(0), _crops(0, 2))
    assert made == []


def test_spans_under_a_profiler():
    """Each block opens ``frp.swin.attn`` and ``frp.swin.mlp`` once and
    ``frp.swin.sdpa`` once inside attn; ``frp.swin.window`` twice inside
    attn in stages 1-3 (the gather and its reverse), never in stage 4;
    ``frp.swin.merge`` once a stage change."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _port(_weights(0), _crops(0, 2))
    events = [e for e in prof.events() if e.name.startswith("frp.swin.")]
    names = [e.name for e in events]
    blocks = sum(SMALL["depths"])
    assert names.count("frp.swin.attn") == names.count("frp.swin.mlp") == blocks
    assert names.count("frp.swin.sdpa") == blocks
    assert names.count("frp.swin.window") == 2 * sum(SMALL["depths"][:3])
    assert names.count("frp.swin.merge") == len(SMALL["depths"]) - 1
    for e in events:
        if e.name in ("frp.swin.sdpa", "frp.swin.window"):
            assert e.cpu_parent is not None and e.cpu_parent.name == "frp.swin.attn"


# -- the benchmark's reference copy ------------------------------------------


def _bench_embedder():
    from perfbench.reference.embedders import resolve

    return resolve("swin_t")


def test_bench_reference_equals_the_test_reference(tmp_path):
    """``perfbench/reference/embedders/swin.py`` on a small tree read back
    from a weights file as the harness reads it equals
    ``tests/swin_reference.py``, and so does the port in float32."""
    from perfbench.reference.pipeline import load_npz

    tree = _weights(6)
    save_params(str(tmp_path / "s.npz"), tree)
    x = _crops(6, 4)
    got = _bench_embedder().forward(load_npz(str(tmp_path / "s.npz"), "cpu"), x)
    want = swin_reference.forward(tree, x)
    assert _dist(got, want) <= F32_TOL
    assert _dist(_port(tree, x), want) <= F32_TOL


def test_bench_leaves_equal_init_swin():
    leaves = _bench_embedder().leaves("swin_t", 512)
    tree = flatten_params(swin.init_swin(0, "swin_t", 512))
    assert {k: tuple(v.shape) for k, v in tree.items()} == {k: s for k, (s, _) in leaves.items()}
    kinds = {kind for _, kind in leaves.values()}
    assert "zero" not in kinds and kinds <= {"conv", "dense", "gamma", "beta", "mean", "var"}
    assert all(kind == "beta" for k, (_, kind) in leaves.items()
               if k.endswith(("/b", "rel_bias")))
    assert sum(int(np.prod(s)) for s, _ in leaves.values()) == 28_504_058


def test_bench_reference_counts_and_rounds_every_matmul():
    """On meta tensors at the published widths one face is 8.96 GFLOP
    (patch conv, the blocks' linears and windowed attention, the merges,
    the head), and ``q`` meets both operands of each of those matmuls."""
    emb = _bench_embedder()
    p = _unflatten({k: torch.empty(s, device="meta")
                    for k, (s, _) in emb.leaves("swin_t", 512).items()})
    x = torch.empty((1, 112, 112, 3), device="meta")
    calls = []

    def q(t):
        calls.append(tuple(t.shape))
        return t

    with FlopCounterMode(display=False) as fc:
        y = emb.forward(p, x, q)
    want = 2 * 3136 * 12 * 96
    for s, depth in enumerate((2, 2, 6, 2)):
        t, c = 3136 // 4 ** s, 96 * 2 ** s
        want += depth * (2 * t * (c * 3 * c + c * c + 2 * c * 4 * c) + 2 * 2 * t * 49 * c)
        if s < 3:
            want += 2 * (t // 4) * 4 * c * 2 * c
    want += 2 * 768 * 768 + 2 * 768 * 512
    assert fc.get_total_flops() == want == 8_959_887_360
    assert tuple(y.shape) == (1, 512)
    assert len(calls) == 2 + 12 * 12 + 3 * 2 + 4
    assert calls[:2] == [(1, 3, 112, 112), (96, 3, 2, 2)]
    assert calls[4:8] == [(64, 3, 49, 32), (64, 3, 49, 32), (64, 3, 49, 49), (64, 3, 49, 32)]
