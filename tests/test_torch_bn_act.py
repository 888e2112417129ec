"""PyTorch port, the one-pass BN-activation and BN-add-BN chains
(``frp_tpu_torch/ops/bn_act_cuda.py``) of the iresnet embedder and the
RetinaFace detector on the CPU: the plain twins are the eager chain of
``nn.batch_norm``, ``nn.prelu`` or ``nn.leaky_relu``, ``F.pad`` and ``+``
bit for bit, in every mode, at f32 and bf16 and at the detector's and the
four iresnet widths; the launch checks refuse what the kernel cannot take;
the inference forwards through the twins equal the eager forwards bit for
bit, and only a forward that autograd records nothing of reaches them. The
kernel itself is held on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from frp_tpu_torch.models import iresnet, nn, retinaface
from frp_tpu_torch.models.params import convert_params
from frp_tpu_torch.ops import bn_act_cuda
from frp_tpu_torch.testing.onnx_export import realistic_stats

# the detector's widths below 64, then iresnet's (the detector's go to 256)
WIDTHS = (8, 16, 32, 64, 128, 256, 512)


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs its files in parallel worker processes: two intra-op
    threads a test keep those from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
MODES = ("stem", "prelu", "prelu_pad", "leaky", "leaky_pad", "add", "add_last", "down",
         "down_last")


def _bn(rng, c):
    return {"gamma": torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
            "beta": torch.from_numpy(rng.normal(0, 0.3, c).astype(np.float32)),
            "mean": torch.from_numpy(rng.normal(0, 0.3, c).astype(np.float32)),
            "var": torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32))}


def _act(x):
    """x [B, H, W, C] as the NCHW view of channels-last memory a conv gives."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _case(mode, c, dtype, seed=0):
    rng = np.random.default_rng(seed + c)
    x = _act(rng.normal(0, 1.0, (2, 6, 6, c)).astype(np.float32)).to(dtype)
    sc = _act(rng.normal(0, 1.0, (2, 6, 6, c)).astype(np.float32)).to(dtype)
    layers = {"bn": _bn(rng, c), "down_bn": _bn(rng, c), "bn_next": _bn(rng, c),
              "act": {"alpha": torch.from_numpy(rng.uniform(0.05, 0.45, c).astype(np.float32))}}
    return x, sc, layers


def _chain(mode, x, sc, p):
    """Each mode written out as the eager chain the forwards ran."""
    if mode.startswith("leaky"):
        y = nn.leaky_relu(nn.batch_norm(p["bn"], x))
        return (F.pad(y, (0, 1, 0, 1)) if mode == "leaky_pad" else y), None
    if mode.startswith("stem") or mode.startswith("prelu"):
        y = nn.prelu(p["act"], nn.batch_norm(p["bn"], x))
        if mode == "prelu_pad":
            return F.pad(y, (0, 1, 0, 1)), None
        return y, (nn.batch_norm(p["bn_next"], y) if mode == "stem" else None)
    if mode.startswith("down"):
        sc = nn.batch_norm(p["down_bn"], sc)
    r = sc + nn.batch_norm(p["bn"], x)
    return (None if mode.endswith("_last") else r), nn.batch_norm(p["bn_next"], r)


def _twin(mode, x, sc, p):
    if mode.startswith("leaky"):
        return bn_act_cuda.bn_leaky_plain(x, p["bn"], 0.1,
                                          pad=(1, 1) if mode == "leaky_pad" else None), None
    if mode in ("stem", "prelu", "prelu_pad"):
        got = bn_act_cuda.bn_prelu_plain(x, p["bn"], p["act"],
                                         bn_next=p["bn_next"] if mode == "stem" else None,
                                         pad=(1, 1) if mode == "prelu_pad" else None)
        return got if mode == "stem" else (got, None)
    return bn_act_cuda.bn_add_plain(
        x, p["bn"], sc, p["bn_next"], down_bn=p["down_bn"] if mode.startswith("down") else None,
        keep=not mode.endswith("_last"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("mode", MODES)
def test_plain_twin_is_the_eager_chain(mode, c, dtype):
    x, sc, p = _case(mode, c, dtype)
    want = _chain(mode, x, sc, p)
    got = _twin(mode, x, sc, p)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == dtype and torch.equal(g, w)
    if mode.endswith("_pad"):
        assert got[0].shape == (2, c, 7, 7) and not got[0][:, :, 6].any() and not got[0][..., 6].any()


def test_the_wrappers_take_cpu_tensors_to_the_twins():
    x, sc, p = _case("down", 64, torch.bfloat16)
    r, u = bn_act_cuda.bn_add(x, p["bn"], sc, p["bn_next"], down_bn=p["down_bn"])
    want = _chain("down", x, sc, p)
    assert torch.equal(r, want[0]) and torch.equal(u, want[1])
    y, u = bn_act_cuda.bn_prelu(x, p["bn"], p["act"], bn_next=p["bn_next"])
    want = _chain("stem", x, sc, p)
    assert torch.equal(y, want[0]) and torch.equal(u, want[1])
    y = bn_act_cuda.bn_leaky(x, p["bn"], pad=(1, 1))
    assert torch.equal(y, _chain("leaky_pad", x, sc, p)[0])


def test_the_leaky_slope_is_one_python_float():
    """The leaky slope is a Python float on either route, as nn.leaky_relu
    multiplies by it (in f32 on the card); a tensor of slopes, such as a bf16
    vector of 0.1 (0.10009765625, another model), is refused."""
    x, _, p = _case("leaky", 64, torch.bfloat16)
    assert torch.equal(bn_act_cuda.bn_leaky(x, p["bn"], 0.2), nn.leaky_relu(nn.batch_norm(p["bn"], x), 0.2))
    for slope in (torch.full((64,), 0.1, dtype=torch.bfloat16), torch.tensor(0.1), np.float32(0.1)):
        with pytest.raises(ValueError, match="slope"):
            bn_act_cuda.bn_leaky(x, p["bn"], slope)


def _params(x, p):
    s, t = nn.bn_fold(p["bn"], x)
    return {"s": s, "t": t, "a": nn._cast(p["act"], "alpha", x.dtype)}


@pytest.mark.parametrize("c", WIDTHS)
def test_launch_checks_take_what_the_kernel_takes(c):
    """At every iresnet width a channels-last bf16 or f32 activation and its
    folds pass the checks a launch makes first; the vectors a pixel are
    C / 8 in bf16 and C / 4 in f32."""
    for dtype, lanes in ((torch.bfloat16, 8), (torch.float32, 4)):
        x, sc, p = _case("add", c, dtype)
        assert x.is_contiguous(memory_format=torch.channels_last)
        cv, ho, wo, ptr = bn_act_cuda.operands(x, sc, _params(x, p), (1, 1))
        assert (cv, ho, wo) == (c // lanes, 7, 7) and set(ptr) == {"s", "t", "a"}


def test_launch_checks_refuse_what_the_kernel_cannot_take():
    """Before any launch: a tensor that is not channels-last, a dtype the
    kernel has no lanes for, a parameter or shortcut that does not fit C,
    and a C whose vectors a pixel do not divide a block's threads."""
    x, sc, p = _case("add", 64, torch.bfloat16)
    params = _params(x, p)
    with pytest.raises(ValueError, match="channels-last"):
        bn_act_cuda.operands(x.contiguous(), None, params, None)
    with pytest.raises(ValueError, match="channels-last"):
        bn_act_cuda.operands(x, sc.contiguous(), params, None)
    for dtype in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(ValueError, match="f32 or bf16"):
            bn_act_cuda.operands(x.to(dtype), None, params, None)
    with pytest.raises(ValueError, match="C=64"):
        bn_act_cuda.operands(x, None, {**params, "s": params["s"][:32]}, None)
    with pytest.raises(ValueError, match="C=64"):
        bn_act_cuda.operands(x, None, {**params, "t": params["t"].float()}, None)
    with pytest.raises(ValueError, match="shortcut"):
        bn_act_cuda.operands(x, sc[:, :32].contiguous(memory_format=torch.channels_last),
                             params, None)
    x12, _, _ = _case("add", 12, torch.bfloat16)
    with pytest.raises(ValueError, match="C=12"):
        bn_act_cuda.operands(x12, None, {}, None)
    with pytest.raises(ValueError, match="CUDA"):
        bn_act_cuda._launch(bn_act_cuda.PRELU | bn_act_cuda.WRITE_R, x, None, params, None,
                            (True, False))


def test_explicit_pad_is_the_copy_conv_makes():
    """conv2 of a stride-2 block on an even map pads (0, 1) by a copy under
    XLA SAME: the producer writes that row and column. A map odd on one side
    (pads (1, 1) there, so the copy pads before the input too), odd maps,
    stride 1 and the "torch" mode leave the padding to the conv."""
    w3 = {"w": torch.zeros(8, 8, 3, 3)}
    assert nn.explicit_pad(w3, (112, 112), 2) == (1, 1)
    assert nn.explicit_pad(w3, (56, 55), 2) is None
    assert nn.explicit_pad(w3, (7, 7), 2) is None
    assert nn.explicit_pad(w3, (56, 56), 1) is None
    nn.set_padding_mode("torch")
    try:
        assert nn.explicit_pad(w3, (112, 112), 2) is None
    finally:
        nn.set_padding_mode("same")


@pytest.fixture
def calls(monkeypatch):
    """Counts the forward's calls of the two wrappers."""
    n = {"bn_prelu": 0, "bn_leaky": 0, "bn_add": 0}
    for name in n:
        real = getattr(bn_act_cuda, name)

        def counted(*args, _real=real, _name=name, **kw):
            n[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(bn_act_cuda, name, counted)
    return n


@pytest.mark.parametrize("padding", ["same", "torch"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inference_forward_through_the_twins_is_the_block_forward(calls, dtype, padding):
    """iresnet18 with fitted-looking BN stats: the forward that autograd
    records nothing of goes through the wrappers, one call for the stem and
    two a block, and equals the forward block by block (taken when the input
    requires grad) bit for bit, in both padding modes."""
    params = convert_params(realistic_stats(iresnet.init_iresnet(0, "iresnet18", 128),
                                            np.random.default_rng(1)))
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 0.5, (2, 112, 112, 3))
                         .astype(np.float32)).to(dtype)
    nn.set_padding_mode(padding)
    try:
        with torch.no_grad():
            got = iresnet.iresnet_forward(params, x)
        assert calls == {"bn_prelu": 1 + 8, "bn_leaky": 0, "bn_add": 8}
        want = iresnet.iresnet_forward(params, x.clone().requires_grad_(True))
        assert calls == {"bn_prelu": 1 + 8, "bn_leaky": 0, "bn_add": 8}
    finally:
        nn.set_padding_mode("same")
    assert want.requires_grad and torch.equal(got, want.detach())


@pytest.mark.parametrize("padding", ["same", "torch"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["leaky", "prelu"])
def test_detector_forward_through_the_twins_is_the_eager_forward(calls, act, dtype, padding):
    """RetinaFace with fitted-looking BN stats: the forward that autograd
    records nothing of goes through the wrappers, one call an activated
    conv (38: the stem, 13 depthwise-separable pairs, 3 laterals, 2
    top-down convs, 6 SSH convs), leaky ReLU or PReLU as the layers hold
    slopes, and equals the eager forward (taken when the input requires
    grad) bit for bit, in both padding modes. Under "same" the two pointwise
    convs before a stride-2 depthwise conv inside stage 1 write its padded
    input; the stage outputs, which the FPN reads too, are not padded."""
    params = convert_params(realistic_stats(retinaface.init_retinaface(0, act=act),
                                            np.random.default_rng(1), gamma=(0.5, 1.5)))
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 0.5, (2, 96, 96, 3))
                         .astype(np.float32)).to(dtype)
    pads = []
    real = nn.explicit_pad

    def explicit_pad(*args):
        pads.append(real(*args))
        return pads[-1]

    want_calls = {"bn_prelu": 38 * (act == "prelu"), "bn_leaky": 38 * (act == "leaky"),
                  "bn_add": 0}
    nn.set_padding_mode(padding)
    try:
        with torch.no_grad():
            nn.explicit_pad = explicit_pad
            try:
                got = retinaface.retinaface_forward(params, x)
            finally:
                nn.explicit_pad = real
        assert calls == want_calls
        want = retinaface.retinaface_forward(params, x.clone().requires_grad_(True))
        assert calls == want_calls
    finally:
        nn.set_padding_mode("same")
    assert [p for p in pads if p is not None] == ([(1, 1)] * 2 if padding == "same" else [])
    for k in ("loc", "ldm", "score", "cls_logits"):
        assert want[k].requires_grad and torch.equal(got[k], want[k].detach()), k


def test_training_and_recorded_forwards_never_reach_the_wrappers(monkeypatch):
    """train=True (batch statistics), and a forward whose parameters require
    grad (iresnet's, and the detector's as its trainer runs it), take the
    eager forward: the wrappers are never called."""
    def refuse(*args, **kw):
        raise AssertionError("the wrapper was reached")

    monkeypatch.setattr(bn_act_cuda, "bn_prelu", refuse)
    monkeypatch.setattr(bn_act_cuda, "bn_leaky", refuse)
    monkeypatch.setattr(bn_act_cuda, "bn_add", refuse)
    params = convert_params(iresnet.init_iresnet(0, "iresnet18", 64))
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 0.5, (2, 112, 112, 3))
                         .astype(np.float32))
    emb, stats = iresnet.iresnet_forward(params, x, train=True)
    assert emb.shape == (2, 64) and ("head_bn",) in stats
    params["fc"]["w"].requires_grad_(True)
    emb = iresnet.iresnet_forward(params, x)
    assert emb.requires_grad
    with torch.no_grad(), pytest.raises(AssertionError, match="reached"):
        iresnet.iresnet_forward(params, x)
    # the detector as its trainer runs it: parameters that require grad
    det = convert_params(retinaface.init_retinaface(0))
    det["stem"]["conv"]["w"].requires_grad_(True)
    out = retinaface.retinaface_forward(det, x[:1, :64, :64])
    assert out["score"].requires_grad
    with torch.no_grad(), pytest.raises(AssertionError, match="reached"):
        retinaface.retinaface_forward(det, x[:1, :64, :64])
