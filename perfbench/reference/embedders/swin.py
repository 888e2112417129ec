"""SwinFace's Swin-T face embedder, the plain float32 reference of the
``swin-t-512`` configuration: the recognition backbone of SwinFace
(arXiv:2308.11509, github.com/lxq1000/SwinFace), the Swin Transformer
(arXiv:2103.14030; microsoft/Swin-Transformer
``swin_tiny_patch4_window7_224``: width 96, depths 2-2-6-2, heads 3-6-12-24,
window 7, MLP ratio 4, qkv bias, patch norm) at patch 2 on 112 x 112 crops,
at inference:

    Conv2d(3, 96, 2, stride 2) -> 3136 tokens on a 56 x 56 grid -> LN
    each stage's blocks (grid G = 56, 28, 14, 7; shift 3 in odd blocks
    where G > 7, else 0):
      x = x + roll(windows back(proj(attn(windows(roll(LN1(x), -shift))))),
          shift); attn = softmax(q k^T * 32 ** -0.5 + B[rel_index] + mask) v
          in 7x7 windows, B the block's table [169, heads], mask Swin's
          -100 between regions of the rolled grid in shifted blocks
      x = x + fc2(GELU(fc1(LN2(x))))      exact GELU
    between stages: cat(x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2],
      x[1::2, 1::2]) -> LN(4C) -> Linear 2C (no bias)
    LN -> mean over the 49 tokens -> Linear 768 (no bias) -> BN1d
      -> Linear 512 (no bias) -> BN1d -> L2 normalisation

LayerNorm eps 1e-5, BN1d eps 2e-5 (running statistics). Every matmul
input and its weight passes through ``q``: the patch conv, qkv, q and k of
q k^T, P and v of P v, proj, fc1, fc2, each merge's linear and both head
linears, so that the control's rounding reaches the attention too.
Departures: drop path acts only in training and is left out; the head
(Linear, BN1d, Linear, BN1d on the pooled token, arcface_torch's form) is
assumed, and SwinFace's expression, age and attribute subnets are left
out; the L2 normalisation is the engine's. A copy of the repository's test
reference (``tests/swin_reference.py``) with ``q`` added; it imports
nothing of the program under test, and runs on meta tensors for the FLOP
count.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

ARCHS = ("swin_t",)
WIDTH, DEPTHS, HEADS, WINDOW, MLP_RATIO, PATCH, CROP = 96, (2, 2, 6, 2), (3, 6, 12, 24), 7, 4, 2, 112
LN_EPS = 1e-5
BN_EPS = 2e-5


def _ident(x):
    return x


def _ln(p, x):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * p["gamma"] + p["beta"]


def _bn(p, x):
    return (x - p["mean"]) / torch.sqrt(p["var"] + BN_EPS) * p["gamma"] + p["beta"]


def _linear(p, x, q):
    y = q(x) @ q(p["w"])
    return y + p["b"] if "b" in p else y


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _partition(x, w):
    k, g, _, c = x.shape
    return x.view(k, g // w, w, g // w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def _reverse(x, w, g):
    c = x.shape[-1]
    return x.view(-1, g // w, g // w, w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, g, g, c)


def _rel_index(w):
    coords = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    return (rel[:, :, 0] + w - 1) * (2 * w - 1) + rel[:, :, 1] + w - 1


def _shift_mask(g, w, shift):
    img = torch.zeros(1, g, g, 1)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    mw = _partition(img, w).squeeze(-1)
    mask = mw[:, None, :] - mw[:, :, None]
    return torch.where(mask != 0, -100.0, 0.0)


def _block(p, x, g, shift, q):
    k, _, c = x.shape
    table = p["rel_bias"]
    heads, w = table.shape[1], WINDOW
    n = w * w
    h = _ln(p["ln1"], x).view(k, g, g, c)
    if shift:
        h = torch.roll(h, (-shift, -shift), (1, 2))
    qkv = _linear(p["qkv"], _partition(h, w), q)
    qkv = qkv.reshape(-1, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    attn = q(qkv[0]) @ q(qkv[1]).transpose(-2, -1) * (c // heads) ** -0.5
    idx = _rel_index(w).reshape(-1).to(table.device)
    attn = attn + table[idx].view(n, n, heads).permute(2, 0, 1)
    if shift:
        nw = (g // w) ** 2
        mask = _shift_mask(g, w, shift).to(attn.device)
        attn = (attn.view(k, nw, heads, n, n) + mask[None, :, None]).view(-1, heads, n, n)
    o = (q(torch.softmax(attn, dim=-1)) @ q(qkv[2])).transpose(1, 2).reshape(-1, n, c)
    o = _reverse(_linear(p["proj"], o, q), w, g)
    if shift:
        o = torch.roll(o, (shift, shift), (1, 2))
    x = x + o.reshape(k, g * g, c)
    return x + _linear(p["fc2"], _gelu(_linear(p["fc1"], _ln(p["ln2"], x), q)), q)


def _merge(p, x, g, q):
    k, _, c = x.shape
    x = x.view(k, g, g, c)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
    return _linear(p["reduction"], _ln(p["norm"], x.reshape(k, -1, 4 * c)), q)


def forward(p, x, q=_ident):
    """x [K, 112, 112, 3] normalised crops -> [K, D] unit float32
    embeddings; each block's head count is its table's second axis."""
    pe = p["patch_embed"]
    w = pe["w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(q(x.permute(0, 3, 1, 2)), q(w), pe["b"], stride=w.shape[-1])
    g = y.shape[-1]
    y = _ln(p["patch_norm"], y.flatten(2).transpose(1, 2))
    for stage in p["stages"]:
        for i, b in enumerate(stage["blocks"]):
            y = _block(b, y, g, WINDOW // 2 if g > WINDOW and i % 2 else 0, q)
        if "merge" in stage:
            y = _merge(stage["merge"], y, g, q)
            g //= 2
    y = _ln(p["norm"], y).mean(1)
    head = p["head"]
    y = _bn(head["bn1"], _linear(head["fc1"], y, q))
    y = _bn(head["bn2"], _linear(head["fc2"], y, q))
    return y / torch.sqrt(torch.clamp((y * y).sum(-1, keepdim=True), min=1e-12))


def leaves(arch: str, embed_dim: int) -> dict:
    """{key: (shape, kind)} of the ``swin_t.npz`` the program loads: the
    patch conv HWIO ("conv"), linear weights [in, out] ("dense"), LN gammas
    and the BN1d units' gammas and variances drawn as "gamma" and "var",
    and every bias, relative-position table, LN beta and BN1d beta and mean
    as "beta" or "mean" (never "zero": a bias the program dropped must
    show)."""
    if arch not in ARCHS:
        raise SystemExit(f"{__file__} serves {ARCHS}, not {arch!r}")
    out: dict = {"patch_embed/w": ((PATCH, PATCH, 3, WIDTH), "conv"),
                 "patch_embed/b": ((WIDTH,), "beta")}

    def ln(prefix, c):
        out[f"{prefix}/gamma"] = ((c,), "gamma")
        out[f"{prefix}/beta"] = ((c,), "beta")

    def dense(prefix, cin, cout, bias=True):
        out[f"{prefix}/w"] = ((cin, cout), "dense")
        if bias:
            out[f"{prefix}/b"] = ((cout,), "beta")

    def bn(prefix, c):
        for kind in ("gamma", "beta", "mean", "var"):
            out[f"{prefix}/{kind}"] = ((c,), kind)

    ln("patch_norm", WIDTH)
    for s, (depth, heads) in enumerate(zip(DEPTHS, HEADS)):
        c = WIDTH * 2 ** s
        for i in range(depth):
            b = f"stages/{s}/blocks/{i}"
            ln(f"{b}/ln1", c)
            dense(f"{b}/qkv", c, 3 * c)
            out[f"{b}/rel_bias"] = (((2 * WINDOW - 1) ** 2, heads), "beta")
            dense(f"{b}/proj", c, c)
            ln(f"{b}/ln2", c)
            dense(f"{b}/fc1", c, MLP_RATIO * c)
            dense(f"{b}/fc2", MLP_RATIO * c, c)
        if s + 1 < len(DEPTHS):
            ln(f"stages/{s}/merge/norm", 4 * c)
            dense(f"stages/{s}/merge/reduction", 4 * c, 2 * c, bias=False)
    c = WIDTH * 2 ** (len(DEPTHS) - 1)
    ln("norm", c)
    dense("head/fc1", c, c, bias=False)
    bn("head/bn1", c)
    dense("head/fc2", c, embed_dim, bias=False)
    bn("head/bn2", embed_dim)
    return out
