"""A plain float32 reference of InsightFace's ViT face embedder, for the
port's tests: arcface_torch's ``backbones/vit.py``
(github.com/deepinsight/insightface, ``recognition/arcface_torch``;
``vit_l_dp005_mask_005``: patch 9, width 768, depth 24, 8 heads, MLP
3072, 512-d) at inference, written from its equations in plain ``torch``:

    x = Conv2d(3, W, 9, stride 9)(crop NCHW).flatten(2).transpose(1, 2)
        + pos_embed                                       [K, 144, W]
    each block: x = x + proj(attn(LN1(x))); x = x + fc2(ReLU6(fc1(LN2(x))))
        attn: qkv (no bias) reshaped [K, T, 3, H, W / H], softmax over the
        keys of q k^T * (W / H) ** -0.5, times v, heads joined
    LN(x) -> reshape [K, T * W] -> Linear W (no bias) -> BN1d
        -> Linear D (no bias) -> BN1d -> L2 normalisation

LayerNorm eps 1e-5 (nn.LayerNorm's default), BN1d eps 2e-5, inference
BN from the running statistics. Departures from the source: none in the
arithmetic; drop path and patch masking act only in training and are left
out; the weights are the flat tree of the port's files (the patch conv
HWIO, linear weights [in, out], pos_embed [T, W]) rather than a
state dict; the L2 normalisation is the engine's, after the backbone.

Float32 throughout, with TF32 off while it runs. It imports nothing of the
port or of JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LN_EPS = 1e-5
BN_EPS = 2e-5


def _t(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32)


def layer_norm(p, x):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * _t(p["gamma"]) + _t(p["beta"])


def batch_norm(p, x):
    return (x - _t(p["mean"])) / torch.sqrt(_t(p["var"]) + BN_EPS) * _t(p["gamma"]) + _t(p["beta"])


def linear(p, x):
    y = x @ _t(p["w"])
    return y + _t(p["b"]) if "b" in p else y


def block(p, x, heads: int):
    k, t, w = x.shape
    qkv = linear(p["qkv"], layer_norm(p["ln1"], x))
    qkv = qkv.reshape(k, t, 3, heads, w // heads).permute(2, 0, 3, 1, 4)
    q, kk, v = qkv[0], qkv[1], qkv[2]
    attn = torch.softmax(q @ kk.transpose(-2, -1) * (w // heads) ** -0.5, dim=-1)
    o = (attn @ v).transpose(1, 2).reshape(k, t, w)
    x = x + linear(p["proj"], o)
    h = torch.clamp(linear(p["fc1"], layer_norm(p["ln2"], x)), 0.0, 6.0)
    return x + linear(p["fc2"], h)


def forward(params, x, heads: int = 8) -> torch.Tensor:
    """x [K, 112, 112, 3] normalised crops -> [K, D] unit float32
    embeddings."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        x = _t(x)
        pe = params["patch_embed"]
        w = _t(pe["w"]).permute(3, 2, 0, 1)  # HWIO -> OIHW
        y = F.conv2d(x.permute(0, 3, 1, 2), w, _t(pe["b"]), stride=w.shape[-1])
        y = y.flatten(2).transpose(1, 2) + _t(params["pos_embed"])
        for p in params["blocks"]:
            y = block(p, y, heads)
        y = layer_norm(params["norm"], y).reshape(y.shape[0], -1)
        head = params["head"]
        y = batch_norm(head["bn1"], linear(head["fc1"], y))
        y = batch_norm(head["bn2"], linear(head["fc2"], y))
        return y / torch.sqrt(torch.clamp((y * y).sum(-1, keepdim=True), min=1e-12))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was
