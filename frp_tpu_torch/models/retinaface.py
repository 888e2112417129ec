"""RetinaFace (MobileNetV1-0.25 backbone + FPN + SSH) in PyTorch (port of
``frp_tpu/models/retinaface.py``). Same three-stride anchor layout as
``ops/anchors.py`` (strides 8/16/32, 2 anchors per cell): A = 16800 at 640.
"""

from __future__ import annotations

import torch

from frp_tpu_torch.models import nn

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


def _cba(p, x, stride: int = 1, groups: int = 1):
    y = nn.conv_bn(p, x, stride=stride, groups=groups)
    return nn.prelu(p["act"], y) if "act" in p else nn.leaky_relu(y)


def _dw_sep_init(rng, cin, cout, prelu=False):
    return {
        "dw": _cba_init(rng, 3, 3, cin, cin, groups=cin, prelu=prelu),
        "pw": _cba_init(rng, 1, 1, cin, cout, prelu=prelu),
    }


def _dw_sep(p, x, stride):
    y = _cba(p["dw"], x, stride=stride, groups=x.shape[1])
    return _cba(p["pw"], y)


def _ssh_init(rng, cin, cout, prelu=False):
    half, quarter = cout // 2, cout // 4
    return {
        "conv3": nn.conv_bn_init(rng, 3, 3, cin, half),
        "conv5_1": _cba_init(rng, 3, 3, cin, quarter, prelu=prelu),
        "conv5_2": nn.conv_bn_init(rng, 3, 3, quarter, quarter),
        "conv7_2": _cba_init(rng, 3, 3, quarter, quarter, prelu=prelu),
        "conv7_3": nn.conv_bn_init(rng, 3, 3, quarter, quarter),
    }


def _ssh(p, x):
    c3 = nn.conv_bn(p["conv3"], x)
    c5_1 = _cba(p["conv5_1"], x)
    c5 = nn.conv_bn(p["conv5_2"], c5_1)
    c7_2 = _cba(p["conv7_2"], c5_1)
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
    "cls_logits": [B, A, 2]} in float32."""
    y = _cba(params["stem"], x.permute(0, 3, 1, 2), stride=2)
    feats = []
    for name, plan in (("stage1", _STAGE1), ("stage2", _STAGE2), ("stage3", _STAGE3)):
        for p, (_, stride) in zip(params[name], plan):
            y = _dw_sep(p, y, stride)
        feats.append(y)

    lat = [_cba(p, f) for p, f in zip(params["fpn_lat"], feats)]
    p3 = lat[2]
    p2 = lat[1] + nn.upsample2x(p3, lat[1].shape[2:4])
    p2 = _cba(params["fpn_td"][0], p2)
    p1 = lat[0] + nn.upsample2x(p2, lat[0].shape[2:4])
    p1 = _cba(params["fpn_td"][1], p1)
    pyramid = [p1, p2, p3]

    feats = [_ssh(p, f) for p, f in zip(params["ssh"], pyramid)]
    cls = _head(params["head_cls"], feats, 2).to(torch.float32)
    loc = _head(params["head_box"], feats, 4).to(torch.float32)
    ldm = _head(params["head_ldm"], feats, 10).to(torch.float32)
    score = torch.softmax(cls, dim=-1)[..., 1]
    return {"loc": loc, "ldm": ldm, "score": score, "cls_logits": cls}
