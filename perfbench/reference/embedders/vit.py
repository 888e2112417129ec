"""InsightFace's ViT-L face embedder, the plain float32 reference of the
``vit-l-512`` configuration: arcface_torch's ``backbones/vit.py``
(github.com/deepinsight/insightface, ``recognition/arcface_torch``),
backbone ``vit_l_dp005_mask_005`` (``backbones/__init__.py``: patch 9,
width 768, depth 24, 8 heads, MLP ratio 4, no qkv bias, LayerNorm, 512-d;
trained by ``configs/wf42m_pfc03_40epoch_8gpu_vit_l.py``,
arXiv:2203.15565), at inference:

    Conv2d(3, 768, 9, stride 9) over the 112 x 112 crop (rows and columns
      108-111 never read) -> 144 tokens + pos_embed
    24 blocks: x = x + proj(attn(LN1(x))); x = x + fc2(ReLU6(fc1(LN2(x))))
      attn: qkv [K, T, 3, 8, 96], softmax(q k^T * 96 ** -0.5) v
    LN -> flatten token-major to 110592 -> Linear 768 (no bias) -> BN1d
      -> Linear 512 (no bias) -> BN1d -> L2 normalisation

LayerNorm eps 1e-5, BN1d eps 2e-5 (running statistics). Every matmul
input and its weight passes through ``q``: the patch conv, qkv, q and k of
q k^T, P and v of P v, proj, fc1, fc2 and both head linears, so that the
control's rounding reaches the attention too. Departures: drop path and
patch masking act only in training and are left out; the source's
attention is float32 already, as here; the L2 normalisation is the
engine's. A copy of the repository's test reference
(``tests/vit_reference.py``) with ``q`` added; it imports nothing of the
program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ARCHS = ("vit_l",)
WIDTH, DEPTH, HEADS, MLP, PATCH, CROP = 768, 24, 8, 3072, 9, 112
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


def forward(p, x, q=_ident):
    """x [K, 112, 112, 3] normalised crops -> [K, D] unit float32
    embeddings; the head count is ``HEADS``."""
    pe = p["patch_embed"]
    w = pe["w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(q(x.permute(0, 3, 1, 2)), q(w), pe["b"], stride=w.shape[-1])
    y = y.flatten(2).transpose(1, 2) + p["pos_embed"]
    k, t, width = y.shape
    hd = width // HEADS
    for b in p["blocks"]:
        qkv = _linear(b["qkv"], _ln(b["ln1"], y), q)
        qkv = qkv.reshape(k, t, 3, HEADS, hd).permute(2, 0, 3, 1, 4)
        attn = torch.softmax(q(qkv[0]) @ q(qkv[1]).transpose(-2, -1) * hd ** -0.5, dim=-1)
        o = (q(attn) @ q(qkv[2])).transpose(1, 2).reshape(k, t, width)
        y = y + _linear(b["proj"], o, q)
        h = torch.clamp(_linear(b["fc1"], _ln(b["ln2"], y), q), 0.0, 6.0)
        y = y + _linear(b["fc2"], h, q)
    y = _ln(p["norm"], y).reshape(k, t * width)
    head = p["head"]
    y = _bn(head["bn1"], _linear(head["fc1"], y, q))
    y = _bn(head["bn2"], _linear(head["fc2"], y, q))
    return y / torch.sqrt(torch.clamp((y * y).sum(-1, keepdim=True), min=1e-12))


def leaves(arch: str, embed_dim: int) -> dict:
    """{key: (shape, kind)} of the ``vit_l.npz`` the program loads: the
    patch conv HWIO ("conv"), linear weights [in, out] ("dense"), LN gammas
    and the BN1d units' gammas and variances drawn as "gamma" and "var",
    and every bias, pos_embed, LN beta and BN1d beta and mean as "beta" or
    "mean" (never "zero": a bias the program dropped must show)."""
    if arch not in ARCHS:
        raise SystemExit(f"{__file__} serves {ARCHS}, not {arch!r}")
    tokens = (CROP // PATCH) ** 2
    out: dict = {"patch_embed/w": ((PATCH, PATCH, 3, WIDTH), "conv"),
                 "patch_embed/b": ((WIDTH,), "beta"),
                 "pos_embed": ((tokens, WIDTH), "beta")}

    def ln(prefix):
        out[f"{prefix}/gamma"] = ((WIDTH,), "gamma")
        out[f"{prefix}/beta"] = ((WIDTH,), "beta")

    def dense(prefix, cin, cout, bias=True):
        out[f"{prefix}/w"] = ((cin, cout), "dense")
        if bias:
            out[f"{prefix}/b"] = ((cout,), "beta")

    def bn(prefix, c):
        for kind in ("gamma", "beta", "mean", "var"):
            out[f"{prefix}/{kind}"] = ((c,), kind)

    for i in range(DEPTH):
        b = f"blocks/{i}"
        ln(f"{b}/ln1")
        dense(f"{b}/qkv", WIDTH, 3 * WIDTH, bias=False)
        dense(f"{b}/proj", WIDTH, WIDTH)
        ln(f"{b}/ln2")
        dense(f"{b}/fc1", WIDTH, MLP)
        dense(f"{b}/fc2", MLP, WIDTH)
    ln("norm")
    dense("head/fc1", tokens * WIDTH, WIDTH, bias=False)
    bn("head/bn1", WIDTH)
    dense("head/fc2", WIDTH, embed_dim, bias=False)
    bn("head/bn2", embed_dim)
    return out
