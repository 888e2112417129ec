"""IResNet embedder in PyTorch (port of ``frp_tpu/models/iresnet.py``):
ArcFace's improved ResNet at 112x112, iresnet18/34/50/100, the embedder of
the accuracy profile. ``train=True`` runs BN on the batch's statistics for
the ArcFace step.

Block: BN, 3x3 conv, BN, PReLU, 3x3 conv carrying the stride, BN; a 1x1 conv
(+BN) with the stride on the shortcut where the shape changes. Head: BN, a
flatten in (c, h, w) order, an fc to ``embed_dim``, a 1-D feature BN in f32,
then the L2 normalisation.

At inference, where autograd records nothing, the element-wise chains
between the convs go through ``ops/bn_act_cuda.py``, one pass each: after
the stem conv its BN and PReLU and block 0's bn1; after each conv1 bn2 and
PReLU (into conv2's padded input where conv2 would pad by a copy); after
each conv2 bn3, the shortcut (through down_bn), the add and the next block's
bn1 (head_bn after the last block). On the CPU those are the same ops as the
block below, in the same order.
"""

from __future__ import annotations

import torch

from frp_tpu_torch.models import nn
from frp_tpu_torch.ops import bn_act_cuda

_DEPTHS = {
    "iresnet18": (2, 2, 2, 2),
    "iresnet34": (3, 4, 6, 3),
    "iresnet50": (3, 4, 14, 3),
    "iresnet100": (3, 13, 30, 3),
}
_WIDTHS = (64, 128, 256, 512)
IRESNET_VARIANTS = tuple(_DEPTHS)


def _block_init(rng, cin, cout, stride):
    p = {
        "bn1": nn.bn_init(cin),
        "conv1": nn.conv_init(rng, 3, 3, cin, cout),
        "bn2": nn.bn_init(cout),
        "prelu": nn.prelu_init(cout),
        "conv2": nn.conv_init(rng, 3, 3, cout, cout),
        "bn3": nn.bn_init(cout),
    }
    if stride != 1 or cin != cout:
        p["down_conv"] = nn.conv_init(rng, 1, 1, cin, cout)
        p["down_bn"] = nn.bn_init(cout)
    return p


def _bn(p: dict, name: str, y: torch.Tensor, stats: dict | None, path: tuple,
        group=None) -> torch.Tensor:
    """The bare BN unit p[name]: folded, or (with ``stats``) batch
    statistics, over ``group``'s global batch when one is given, its new
    running stats stored under path + (name,)."""
    if stats is None:
        return nn.batch_norm(p[name], y)
    y, stats[path + (name,)] = nn.batch_norm(p[name], y, train=True, group=group)
    return y


def _block(p, x, stride, stats=None, path=(), group=None):
    y = nn.conv(p["conv1"], _bn(p, "bn1", x, stats, path, group))
    y = nn.prelu(p["prelu"], _bn(p, "bn2", y, stats, path, group))
    y = _bn(p, "bn3", nn.conv(p["conv2"], y, stride=stride), stats, path, group)
    if "down_conv" in p:
        x = _bn(p, "down_bn", nn.conv(p["down_conv"], x, stride=stride), stats, path, group)
    return x + y


def _chains(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The inference trunk through one ``bn_act_cuda`` pass a chain: x NHWC
    -> head_bn of the last block's output, [B, C, 7, 7] (channels-last)."""
    blocks = [(p, 2 if b == 0 else 1) for stage in params["stages"] for b, p in enumerate(stage)]
    y = nn.conv(params["stem"], x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    r, u = bn_act_cuda.bn_prelu(y, params["stem_bn"], params["stem_prelu"],
                                bn_next=blocks[0][0]["bn1"])
    for k, (p, stride) in enumerate(blocks):
        last = k + 1 == len(blocks)
        y = nn.conv(p["conv1"], u)
        pad = nn.explicit_pad(p["conv2"], y.shape[2:], stride)
        y = bn_act_cuda.bn_prelu(y, p["bn2"], p["prelu"], pad=pad)
        y = nn.conv(p["conv2"], y, stride=stride, padding="SAME" if pad is None else "VALID")
        down = None
        if "down_conv" in p:
            r, down = nn.conv(p["down_conv"], r, stride=stride), p["down_bn"]
        r, u = bn_act_cuda.bn_add(y, p["bn3"], r,
                                  params["head_bn"] if last else blocks[k + 1][0]["bn1"],
                                  down_bn=down, keep=not last)
    return u


def init_iresnet(rng_or_seed=0, variant: str = "iresnet18", embed_dim: int = 128) -> dict:
    """Numpy parameter tree, equal to ``frp_tpu.models.iresnet.init_iresnet``
    for the same seed and variant."""
    if variant not in _DEPTHS:
        raise ValueError(f"unknown variant {variant}; options: {sorted(_DEPTHS)}")
    rng = nn.as_rng(rng_or_seed)
    params = {
        "stem": nn.conv_init(rng, 3, 3, 3, 64),
        "stem_bn": nn.bn_init(64),
        "stem_prelu": nn.prelu_init(64),
        "stages": [],
    }
    cin = 64
    for width, n_blocks in zip(_WIDTHS, _DEPTHS[variant]):
        stage = []
        for b in range(n_blocks):
            stage.append(_block_init(rng, cin, width, 2 if b == 0 else 1))
            cin = width
        params["stages"].append(stage)
    # 112 / 2^4 = 7 -> feature map [512, 7, 7]
    params["head_bn"] = nn.bn_init(cin)
    params["fc"] = nn.dense_init(rng, cin * 7 * 7, embed_dim)
    params["feat_bn"] = nn.bn_init(embed_dim)
    return params


def iresnet_forward(params: dict, x: torch.Tensor, normalize: bool = True,
                    train: bool = False, bn_group=None):
    """x: [B, 112, 112, 3] normalized crops, NHWC, any float dtype. Returns
    [B, D] float32 embeddings (L2-normalized unless normalize=False). With
    train=True returns (embeddings, bn_stats): bn_stats maps param-tree paths
    whose last element names a bare BN unit (("stages", 0, 1, "bn2"),
    ("head_bn",), ...) to its updated running stats, as
    ``frp_tpu/models/iresnet.py``; ``bn_group`` (a data process group)
    takes the statistics over its global batch (``nn.batch_norm``)."""
    stats: dict | None = {} if train else None
    g = bn_group
    if stats is None and not nn.records_grad(params, x):
        y = _chains(params, x)
    else:
        y = nn.conv(params["stem"], x.permute(0, 3, 1, 2))
        y = nn.prelu(params["stem_prelu"], _bn(params, "stem_bn", y, stats, (), g))
        for si, stage in enumerate(params["stages"]):
            for b, block in enumerate(stage):
                y = _block(block, y, 2 if b == 0 else 1, stats, ("stages", si, b), g)
        y = _bn(params, "head_bn", y, stats, (), g)
    # the activations are logically NCHW, so a reshape flattens in (c, h, w)
    # order, the order the fc's inputs index (the JAX package transposes its
    # NHWC map to NCHW first); reshape copies a channels-last map as needed
    emb = nn.dense(params["fc"], y.reshape(y.shape[0], -1)).to(torch.float32)
    emb = _bn(params, "feat_bn", emb, stats, (), g)  # 1-D feature BN
    if normalize:
        emb = nn.l2_normalize(emb)
    return (emb, stats) if train else emb
