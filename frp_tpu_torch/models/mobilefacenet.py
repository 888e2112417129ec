"""MobileFaceNet embedder in PyTorch (port of
``frp_tpu/models/mobilefacenet.py``, inference only): 112x112 crops ->
L2-normalized embeddings, PReLU throughout, a linear 7x7 ``VALID`` depthwise
GDConv head."""

from __future__ import annotations

import torch

from frp_tpu_torch.models import nn

_BOTTLENECKS = [
    # (expansion t, out channels c, repeats n, first stride s)
    (2, 64, 5, 2),
    (4, 128, 1, 2),
    (2, 128, 6, 1),
    (4, 128, 1, 2),
    (2, 128, 2, 1),
]


def _bottleneck_init(rng, cin, cout, t):
    hidden = cin * t
    return {
        "expand": nn.conv_bn_init(rng, 1, 1, cin, hidden),
        "expand_prelu": nn.prelu_init(hidden),
        "dw": nn.conv_bn_init(rng, 3, 3, hidden, hidden, groups=hidden),
        "dw_prelu": nn.prelu_init(hidden),
        "project": nn.conv_bn_init(rng, 1, 1, hidden, cout),
    }


def _bottleneck(p, x, stride, residual):
    y = nn.conv_bn(p["expand"], x)
    y = nn.prelu(p["expand_prelu"], y)
    y = nn.conv_bn(p["dw"], y, stride=stride, groups=y.shape[1])
    y = nn.prelu(p["dw_prelu"], y)
    y = nn.conv_bn(p["project"], y)
    return x + y if residual else y


def init_mobilefacenet(rng_or_seed=0, embed_dim: int = 128) -> dict:
    """Numpy parameter tree, equal to
    ``frp_tpu.models.mobilefacenet.init_mobilefacenet`` for the same seed."""
    rng = nn.as_rng(rng_or_seed)
    params = {
        "stem": nn.conv_bn_init(rng, 3, 3, 3, 64),
        "stem_prelu": nn.prelu_init(64),
        "dw1": nn.conv_bn_init(rng, 3, 3, 64, 64, groups=64),
        "dw1_prelu": nn.prelu_init(64),
        "blocks": [],
    }
    cin = 64
    for t, c, n, s in _BOTTLENECKS:
        for _ in range(n):
            params["blocks"].append(_bottleneck_init(rng, cin, c, t))
            cin = c
    params["conv_head"] = nn.conv_bn_init(rng, 1, 1, cin, 512)
    params["head_prelu"] = nn.prelu_init(512)
    params["gdconv"] = nn.conv_bn_init(rng, 7, 7, 512, 512, groups=512)
    params["embed"] = nn.conv_bn_init(rng, 1, 1, 512, embed_dim)
    return params


def mobilefacenet_forward(params: dict, x: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """x: [B, 112, 112, 3] normalized crops ((v-127.5)/128), NHWC, any float
    dtype. Returns [B, D] float32 embeddings (L2-normalized unless
    normalize=False)."""
    y = nn.conv_bn(params["stem"], x.permute(0, 3, 1, 2), stride=2)
    y = nn.prelu(params["stem_prelu"], y)
    y = nn.conv_bn(params["dw1"], y, groups=64)
    y = nn.prelu(params["dw1_prelu"], y)

    i = 0
    cin = 64
    for t, c, n, s in _BOTTLENECKS:
        for j in range(n):
            stride = s if j == 0 else 1
            y = _bottleneck(params["blocks"][i], y, stride, stride == 1 and cin == c)
            cin = c
            i += 1

    y = nn.conv_bn(params["conv_head"], y)
    y = nn.prelu(params["head_prelu"], y)
    y = nn.conv_bn(params["gdconv"], y, groups=512, padding="VALID")
    y = nn.conv_bn(params["embed"], y)
    emb = y.reshape(y.shape[0], -1).to(torch.float32)
    return nn.l2_normalize(emb) if normalize else emb
