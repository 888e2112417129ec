"""MobileFaceNet embedder in PyTorch (port of
``frp_tpu/models/mobilefacenet.py``): 112x112 crops -> L2-normalized
embeddings, PReLU throughout, a linear 7x7 ``VALID`` depthwise GDConv head.
The same forward serves inference (BN folded) and training (``train=True``
returns the batch-statistics BN's updated running stats beside the
embeddings, for the ArcFace step)."""

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


def _bn(block: dict, y: torch.Tensor, stats: dict | None, path: tuple, group=None) -> torch.Tensor:
    """A conv_bn node's BN: folded, or (with ``stats``) batch statistics,
    over ``group``'s global batch when one is given, the node's new running
    stats stored under ``path``."""
    if stats is None:
        return nn.batch_norm(block["bn"], y)
    y, stats[path] = nn.batch_norm(block["bn"], y, train=True, group=group)
    return y


def _bottleneck(p, x, stride, residual, stats=None, path=(), group=None):
    y = _bn(p["expand"], nn.conv(p["expand"]["conv"], x), stats, path + ("expand",), group)
    y = nn.prelu(p["expand_prelu"], y)
    y = nn.conv(p["dw"]["conv"], y, stride=stride, groups=y.shape[1])
    y = nn.prelu(p["dw_prelu"], _bn(p["dw"], y, stats, path + ("dw",), group))
    y = _bn(p["project"], nn.conv(p["project"]["conv"], y), stats, path + ("project",), group)
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


def mobilefacenet_forward(params: dict, x: torch.Tensor, train: bool = False,
                          normalize: bool = True, bn_group=None):
    """x: [B, 112, 112, 3] normalized crops ((v-127.5)/128), NHWC, any float
    dtype. Returns [B, D] float32 embeddings (L2-normalized unless
    normalize=False). With train=True returns (embeddings, bn_stats):
    bn_stats maps the tuple paths of ``frp_tpu/models/mobilefacenet.py``
    (("stem",), ("blocks", 3, "dw"), ...: each a conv_bn node) to its updated
    running stats; ``bn_group`` (a data process group) takes the statistics
    over its global batch (``nn.batch_norm``)."""
    stats: dict | None = {} if train else None
    g = bn_group
    y = nn.conv(params["stem"]["conv"], x.permute(0, 3, 1, 2), stride=2)
    y = nn.prelu(params["stem_prelu"], _bn(params["stem"], y, stats, ("stem",), g))
    y = nn.conv(params["dw1"]["conv"], y, groups=64)
    y = nn.prelu(params["dw1_prelu"], _bn(params["dw1"], y, stats, ("dw1",), g))

    i = 0
    cin = 64
    for t, c, n, s in _BOTTLENECKS:
        for j in range(n):
            stride = s if j == 0 else 1
            y = _bottleneck(params["blocks"][i], y, stride, stride == 1 and cin == c,
                            stats, ("blocks", i), g)
            cin = c
            i += 1

    y = _bn(params["conv_head"], nn.conv(params["conv_head"]["conv"], y), stats, ("conv_head",), g)
    y = nn.prelu(params["head_prelu"], y)
    y = nn.conv(params["gdconv"]["conv"], y, groups=512, padding="VALID")
    y = _bn(params["gdconv"], y, stats, ("gdconv",), g)
    y = _bn(params["embed"], nn.conv(params["embed"]["conv"], y), stats, ("embed",), g)
    emb = y.reshape(y.shape[0], -1).to(torch.float32)
    if normalize:
        emb = nn.l2_normalize(emb)
    return (emb, stats) if train else emb
