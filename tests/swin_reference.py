"""A plain float32 reference of SwinFace's Swin-T face embedder, for the
port's tests: the recognition backbone of SwinFace (arXiv:2308.11509,
github.com/lxq1000/SwinFace), the Swin Transformer (arXiv:2103.14030,
microsoft/Swin-Transformer ``swin_tiny_patch4_window7_224``) at patch 2 on
112 x 112 crops, at inference, written from its equations in plain
``torch``:

    x = Conv2d(3, C, 2, stride 2)(crop NCHW).flatten(2).transpose(1, 2) -> LN
    each stage's blocks (grid G, window 7, shift 3 in odd blocks where
    G > 7, else 0):
        h = roll(LN1(x) on the G x G grid, (-shift, -shift)), cut into 7x7
            windows (row-major windows, row-major tokens)
        attn = softmax(q k^T * (C / H) ** -0.5 + B[rel_index] + mask) v,
            qkv with bias reshaped [windows, 49, 3, H, C / H]; B the block's
            table [169, H]; mask Swin's ``attn_mask`` of the rolled grid
            (-100 between regions), in shifted blocks only
        x = x + roll(windows joined back(proj(attn)), (shift, shift))
        x = x + fc2(GELU(fc1(LN2(x))))       exact GELU, 0.5 x (1 + erf(x/√2))
    between stages: cat(x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2],
        x[1::2, 1::2]) over channels -> LN -> Linear 2C (no bias)
    LN -> mean over tokens -> Linear (no bias) -> BN1d -> Linear D (no
        bias) -> BN1d -> L2 normalisation

LayerNorm eps 1e-5, BN1d eps 2e-5, inference BN from the running
statistics. Departures from the source: none in the backbone's arithmetic
(drop path acts only in training and is left out); the head (Linear, BN1d,
Linear, BN1d on the pooled token) is assumed, and SwinFace's expression,
age and attribute subnets are left out; the weights are the flat tree of
the port's files (the patch conv HWIO, linear weights [in, out], each
block's table ``rel_bias`` [169, H]) rather than a state dict; the L2
normalisation is the engine's, after the backbone.

Float32 throughout, with TF32 off while it runs. It imports nothing of the
port or of JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-5
BN_EPS = 2e-5
WINDOW = 7


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


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def window_partition(x, w):
    """[K, G, G, C] -> [K * (G / w)^2, w * w, C]."""
    k, g, _, c = x.shape
    x = x.view(k, g // w, w, g // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def window_reverse(x, w, g):
    """[K * (G / w)^2, w * w, C] -> [K, G, G, C]."""
    c = x.shape[-1]
    x = x.view(-1, g // w, g // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, g, g, c)


def relative_index(w):
    """Swin's ``relative_position_index`` [w * w, w * w]."""
    coords = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    return (rel[:, :, 0] + w - 1) * (2 * w - 1) + rel[:, :, 1] + w - 1


def shift_mask(g, w, shift):
    """Swin's ``attn_mask`` [(G / w)^2, w * w, w * w] of the rolled grid."""
    img = torch.zeros(1, g, g, 1)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    mw = window_partition(img, w).squeeze(-1)
    mask = mw[:, None, :] - mw[:, :, None]
    return torch.where(mask != 0, -100.0, 0.0)


def block(p, x, g, shift):
    """One Swin block on x [K, G * G, C]."""
    k, _, c = x.shape
    table = _t(p["rel_bias"])
    heads, w = table.shape[1], WINDOW
    n = w * w
    h = layer_norm(p["ln1"], x).view(k, g, g, c)
    if shift:
        h = torch.roll(h, (-shift, -shift), (1, 2))
    win = window_partition(h, w)
    qkv = linear(p["qkv"], win).reshape(-1, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, kk, v = qkv[0], qkv[1], qkv[2]
    attn = q @ kk.transpose(-2, -1) * (c // heads) ** -0.5
    idx = relative_index(w).reshape(-1).to(table.device)
    attn = attn + table[idx].view(n, n, heads).permute(2, 0, 1)
    if shift:
        nw = (g // w) ** 2
        mask = shift_mask(g, w, shift).to(attn.device)
        attn = attn.view(k, nw, heads, n, n) + mask[None, :, None]
        attn = attn.view(-1, heads, n, n)
    o = (torch.softmax(attn, dim=-1) @ v).transpose(1, 2).reshape(-1, n, c)
    o = window_reverse(linear(p["proj"], o), w, g)
    if shift:
        o = torch.roll(o, (shift, shift), (1, 2))
    x = x + o.reshape(k, g * g, c)
    return x + linear(p["fc2"], gelu(linear(p["fc1"], layer_norm(p["ln2"], x))))


def merge(p, x, g):
    k, _, c = x.shape
    x = x.view(k, g, g, c)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
    return linear(p["reduction"], layer_norm(p["norm"], x.reshape(k, -1, 4 * c)))


def forward(params, x) -> torch.Tensor:
    """x [K, 112, 112, 3] normalised crops -> [K, D] unit float32
    embeddings."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        x = _t(x)
        pe = params["patch_embed"]
        w = _t(pe["w"]).permute(3, 2, 0, 1)  # HWIO -> OIHW
        y = F.conv2d(x.permute(0, 3, 1, 2), w, _t(pe["b"]), stride=w.shape[-1])
        g = y.shape[-1]
        y = layer_norm(params["patch_norm"], y.flatten(2).transpose(1, 2))
        for stage in params["stages"]:
            for i, p in enumerate(stage["blocks"]):
                shift = WINDOW // 2 if g > WINDOW and i % 2 else 0
                y = block(p, y, g, shift)
            if "merge" in stage:
                y = merge(stage["merge"], y, g)
                g //= 2
        y = layer_norm(params["norm"], y).mean(1)
        head = params["head"]
        y = batch_norm(head["bn1"], linear(head["fc1"], y))
        y = batch_norm(head["bn2"], linear(head["fc2"], y))
        return y / torch.sqrt(torch.clamp((y * y).sum(-1, keepdim=True), min=1e-12))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was
