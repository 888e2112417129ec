"""MobileNetV3-Small spoof classifier in PyTorch (port of
``frp_tpu/models/mobilenetv3.py``). Class index 1 = fake."""

from __future__ import annotations

import torch

from frp_tpu_torch.models import nn

# (kernel, expanded, out, use_se, use_hs, stride)
_SPEC = [
    (3, 16, 16, True, False, 2),
    (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1),
    (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1),
    (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1),
    (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2),
    (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
]
_LAST_CONV = 576
_HIDDEN = 1024


def _block_init(rng, cin, k, exp, cout, use_se):
    p = {
        "expand": nn.conv_bn_init(rng, 1, 1, cin, exp) if exp != cin else None,
        "dw": nn.conv_bn_init(rng, k, k, exp, exp, groups=exp),
    }
    if use_se:
        p["se"] = nn.se_init(rng, exp)
    p["project"] = nn.conv_bn_init(rng, 1, 1, exp, cout)
    return p


def init_mobilenetv3_small(rng_or_seed=0, num_classes: int = 2) -> dict:
    """Numpy parameter tree, equal to
    ``frp_tpu.models.mobilenetv3.init_mobilenetv3_small`` for the same seed."""
    rng = nn.as_rng(rng_or_seed)
    params = {"stem": nn.conv_bn_init(rng, 3, 3, 3, 16), "blocks": []}
    cin = 16
    for k, exp, cout, use_se, _, _ in _SPEC:
        params["blocks"].append(_block_init(rng, cin, k, exp, cout, use_se))
        cin = cout
    params["last_conv"] = nn.conv_bn_init(rng, 1, 1, cin, _LAST_CONV)
    params["fc1"] = nn.dense_init(rng, _LAST_CONV, _HIDDEN)
    params["fc2"] = nn.dense_init(rng, _HIDDEN, num_classes)
    return params


def mobilenetv3_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, S, 3] ImageNet-normalized crops (NHWC). Returns [B, C]
    float32 logits."""
    y = nn.conv_bn(params["stem"], x.permute(0, 3, 1, 2), stride=2, act=nn.hswish)
    cin = 16
    for p, (k, exp, cout, use_se, use_hs, stride) in zip(params["blocks"], _SPEC):
        act = nn.hswish if use_hs else nn.relu
        inp = y
        if p["expand"] is not None:
            y = nn.conv_bn(p["expand"], y, act=act)
        y = nn.conv_bn(p["dw"], y, stride=stride, groups=y.shape[1], act=act)
        if use_se:
            y = nn.se_block(p["se"], y)
        y = nn.conv_bn(p["project"], y)
        if stride == 1 and cin == cout:
            y = inp + y
        cin = cout
    y = nn.conv_bn(params["last_conv"], y, act=nn.hswish)
    y = nn.global_avg_pool(y)
    y = nn.hswish(nn.dense(params["fc1"], y))
    return nn.dense(params["fc2"], y).to(torch.float32)
