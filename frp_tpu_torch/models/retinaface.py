"""RetinaFace (MobileNetV1-0.25 backbone + FPN + SSH) in PyTorch (port of
``frp_tpu/models/retinaface.py``). Same three-stride anchor layout as
``ops/anchors.py`` (strides 8/16/32, 2 anchors per cell): A = 16800 at 640.

At inference, where autograd records nothing, each activated conv's BN and
activation go through ``ops/bn_act_cuda.py``, one pass each (38 a forward:
the stem, 13 depthwise-separable pairs, 3 FPN laterals, 2 top-down convs and
6 SSH convs): leaky ReLU at 0.1 with the in-repo weights, PReLU with the
layer's slopes where it holds them. Within a stage, a pointwise conv whose
output only feeds the next block's stride-2 depthwise conv writes that
conv's padded input (``nn.explicit_pad``), which then convolves with
"VALID". The SSH's BN-only convs, its concat and ReLU, the FPN's upsample
adds and the convs stay eager. On the CPU those are the same ops as the
eager forward, in the same order; the training forward (``train/detector.py``)
keeps the eager forward.
"""

from __future__ import annotations

import torch

from frp_tpu_torch.models import nn
from frp_tpu_torch.ops import bn_act_cuda

# MobileNetV1-0.25 stage plan: (cout, stride), depthwise-separable after stem.
_STAGE1 = [(16, 1), (32, 2), (32, 1), (64, 2), (64, 1)]          # -> C1 stride 8
_STAGE2 = [(128, 2)] + [(128, 1)] * 5                            # -> C2 stride 16
_STAGE3 = [(256, 2), (256, 1)]                                   # -> C3 stride 32
FPN_CH = 64
NUM_ANCHORS = 2


# Activated conv+bn block: the in-repo weights use weightless leaky-ReLU 0.1;
# real InsightFace det exports carry learned per-channel PReLU slopes, so with
# act="prelu" every activated block holds an "act" {"alpha"} unit, which the
# ONNX importer (models/params.py) fills from a Conv->BN->PRelu run.

def _cba_init(rng, kh, kw, cin, cout, groups: int = 1, prelu: bool = False):
    p = nn.conv_bn_init(rng, kh, kw, cin, cout, groups)
    if prelu:
        p["act"] = nn.prelu_init(cout)
    return p


def _cba(p, x, fused: bool, stride: int = 1, groups: int = 1, padded: bool = False,
         pad: tuple[int, int] | None = None):
    """Conv, BN and activation. ``fused``: the BN and activation in one
    ``bn_act_cuda`` pass (PReLU where the layer holds slopes, else leaky
    ReLU), written with ``pad`` zero rows and columns; ``padded``: x holds
    the conv's padding already."""
    y = nn.conv(p["conv"], x, stride=stride, groups=groups, padding="VALID" if padded else "SAME")
    if not fused:
        y = nn.batch_norm(p["bn"], y)
        return nn.prelu(p["act"], y) if "act" in p else nn.leaky_relu(y)
    if "act" in p:
        return bn_act_cuda.bn_prelu(y, p["bn"], p["act"], pad=pad)
    return bn_act_cuda.bn_leaky(y, p["bn"], pad=pad)


def _dw_sep_init(rng, cin, cout, prelu=False):
    return {
        "dw": _cba_init(rng, 3, 3, cin, cin, groups=cin, prelu=prelu),
        "pw": _cba_init(rng, 1, 1, cin, cout, prelu=prelu),
    }


def _stage(blocks, plan, x, fused: bool):
    """The depthwise-separable pairs of a stage. With ``fused``, a pair whose
    next pair's depthwise conv has stride 2 writes that conv's padded input
    where the conv would pad by a copy (``nn.explicit_pad``); the stage's
    last pair writes its output as it is (the FPN reads it too)."""
    padded = False
    for k, (p, (_, stride)) in enumerate(zip(blocks, plan)):
        y = _cba(p["dw"], x, fused, stride=stride, groups=x.shape[1], padded=padded)
        pad = None
        if fused and k + 1 < len(blocks):  # the pointwise conv keeps y's size
            pad = nn.explicit_pad(blocks[k + 1]["dw"]["conv"], y.shape[2:], plan[k + 1][1])
        x, padded = _cba(p["pw"], y, fused, pad=pad), pad is not None
    return x


def _ssh_init(rng, cin, cout, prelu=False):
    half, quarter = cout // 2, cout // 4
    return {
        "conv3": nn.conv_bn_init(rng, 3, 3, cin, half),
        "conv5_1": _cba_init(rng, 3, 3, cin, quarter, prelu=prelu),
        "conv5_2": nn.conv_bn_init(rng, 3, 3, quarter, quarter),
        "conv7_2": _cba_init(rng, 3, 3, quarter, quarter, prelu=prelu),
        "conv7_3": nn.conv_bn_init(rng, 3, 3, quarter, quarter),
    }


def _ssh(p, x, fused: bool):
    c3 = nn.conv_bn(p["conv3"], x)
    c5_1 = _cba(p["conv5_1"], x, fused)
    c5 = nn.conv_bn(p["conv5_2"], c5_1)
    c7_2 = _cba(p["conv7_2"], c5_1, fused)
    c7 = nn.conv_bn(p["conv7_3"], c7_2)
    return nn.relu(torch.cat([c3, c5, c7], dim=1))


def init_retinaface(rng_or_seed=0, act: str = "leaky") -> dict:
    """Numpy parameter tree of the detector, equal to
    ``frp_tpu.models.retinaface.init_retinaface`` for the same seed and act:
    "leaky" (weightless, the in-repo default) or "prelu" (learned slopes on
    every activated block, the structure real det exports import onto)."""
    if act not in ("leaky", "prelu"):
        raise ValueError(f"act {act!r}: 'leaky' or 'prelu'")
    prelu = act == "prelu"
    rng = nn.as_rng(rng_or_seed)
    params = {"stem": _cba_init(rng, 3, 3, 3, 8, prelu=prelu)}

    def stage(cin, plan):
        blocks = []
        for cout, _ in plan:
            blocks.append(_dw_sep_init(rng, cin, cout, prelu=prelu))
            cin = cout
        return blocks, cin

    params["stage1"], c1 = stage(8, _STAGE1)
    params["stage2"], c2 = stage(c1, _STAGE2)
    params["stage3"], c3 = stage(c2, _STAGE3)
    params["fpn_lat"] = [_cba_init(rng, 1, 1, c, FPN_CH, prelu=prelu) for c in (c1, c2, c3)]
    params["fpn_td"] = [_cba_init(rng, 3, 3, FPN_CH, FPN_CH, prelu=prelu) for _ in range(2)]
    params["ssh"] = [_ssh_init(rng, FPN_CH, FPN_CH, prelu=prelu) for _ in range(3)]
    params["head_cls"] = [nn.conv_init(rng, 1, 1, FPN_CH, NUM_ANCHORS * 2) for _ in range(3)]
    params["head_box"] = [nn.conv_init(rng, 1, 1, FPN_CH, NUM_ANCHORS * 4) for _ in range(3)]
    params["head_ldm"] = [nn.conv_init(rng, 1, 1, FPN_CH, NUM_ANCHORS * 10) for _ in range(3)]
    return params


def _head(convs, feats, dims):
    outs = []
    for p, f in zip(convs, feats):
        y = nn.conv(p, f)  # [B, A*dims, H, W]
        b, _, h, w = y.shape
        outs.append(y.permute(0, 2, 3, 1).reshape(b, h * w * NUM_ANCHORS, dims))
    return torch.cat(outs, dim=1)


def retinaface_forward(params: dict, x: torch.Tensor) -> dict:
    """x: [B, S, S, 3] normalized frames (NHWC). Returns raw head outputs
    {"loc": [B, A, 4], "ldm": [B, A, 10], "score": [B, A],
    "cls_logits": [B, A, 2]} in float32. Where autograd records nothing,
    the activated convs' BN and activation run one ``bn_act_cuda`` pass
    each (module docstring)."""
    fused = not nn.records_grad(params, x)
    y = _cba(params["stem"], x.permute(0, 3, 1, 2), fused, stride=2)
    feats = []
    for name, plan in (("stage1", _STAGE1), ("stage2", _STAGE2), ("stage3", _STAGE3)):
        y = _stage(params[name], plan, y, fused)
        feats.append(y)

    lat = [_cba(p, f, fused) for p, f in zip(params["fpn_lat"], feats)]
    p3 = lat[2]
    p2 = lat[1] + nn.upsample2x(p3, lat[1].shape[2:4])
    p2 = _cba(params["fpn_td"][0], p2, fused)
    p1 = lat[0] + nn.upsample2x(p2, lat[0].shape[2:4])
    p1 = _cba(params["fpn_td"][1], p1, fused)
    pyramid = [p1, p2, p3]

    feats = [_ssh(p, f, fused) for p, f in zip(params["ssh"], pyramid)]
    cls = _head(params["head_cls"], feats, 2).to(torch.float32)
    loc = _head(params["head_box"], feats, 4).to(torch.float32)
    ldm = _head(params["head_ldm"], feats, 10).to(torch.float32)
    score = torch.softmax(cls, dim=-1)[..., 1]
    return {"loc": loc, "ldm": ldm, "score": score, "cls_logits": cls}
