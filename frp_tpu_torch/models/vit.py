"""InsightFace's ViT face embedder in PyTorch: arcface_torch's
``backbones/vit.py`` (github.com/deepinsight/insightface,
``recognition/arcface_torch``) at inference, ``vit_l`` being the
``vit_l_dp005_mask_005`` backbone trained on WebFace42M with Partial FC
(arXiv:2203.15565). Drop path and patch masking act in training only and
are left out.

    crop [K, 112, 112, 3] -> rows and columns 0-107 (the 9x9 stride-9 patch
      conv has no padding and never reads 108-111) -> 144 patches of 243
      -> a GEMM with the conv's HWIO weight seen as [243, 768], + bias,
      + pos_embed [144, 768]
    24 pre-LN blocks:
      x = x + proj(attn(LN1(x)))      qkv 768 -> 2304 without bias, 8 heads
                                      of 96, softmax(q k^T / sqrt(96)) v
      x = x + fc2(ReLU6(fc1(LN2(x)))) 768 -> 3072 -> 768
    LN (float32) -> flatten token-major to 110592 -> Linear 768 (no bias)
      -> BN1d -> Linear embed_dim (no bias) -> BN1d -> L2 normalisation

LayerNorms take nn.LayerNorm's eps 1e-5, the head's BN1d eps 2e-5. The
linears run in the compute dtype with the bias inside the GEMM; the final
LN and both BN1d run in float32, as the source's ``self.norm(x.float())``.
Each residual add runs with the LN that reads its sum in one call of
``ops/add_ln_cuda.add_ln`` (on the card one pass of ``csrc/add_ln.cu``,
on the CPU the eager ops): the pos_embed add with block 0's LN1, each
block's proj add with its LN2, each fc2 add with the next block's LN1, and
the last one with the final LN, whose sum nothing else reads: 2 x depth + 1
calls a forward.

**The one departure**: the source computes q k^T, the softmax and P v in
float32 under ``autocast(False)``. Here they run from q, k and v in the
compute dtype through ``F.scaled_dot_product_attention``, whose fused
kernels keep the softmax statistics and the accumulation in float32. The
call is held to the fused backends (``FUSED``: flash first, then
memory-efficient, then cuDNN; on the CPU torch's flash kernel): a layout
that only the math backend takes, which would materialise every score in
float32 ([K, 8, 144, 144]: 1.1 GB at 1664 faces), raises instead of
running slowly.

Under a profiler each block opens the spans ``frp.vit.attn`` (qkv,
attention, proj, the residual add with LN2), ``frp.vit.sdpa`` inside it
around the attention call alone, and ``frp.vit.mlp`` (fc1, ReLU6, fc2, the
add with the next block's LN1 or the final LN); the pos_embed add with
block 0's LN1 runs before the first span.

The parameter tree holds the file's layouts (``convert_params`` makes the
dense weights [out, in] and the patch conv OIHW); the head count is no
leaf, so ``vit_forward`` takes it (``VIT_VARIANTS[arch]["heads"]``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from frp_tpu_torch.models import nn
from frp_tpu_torch.ops import add_ln_cuda
from frp_tpu_torch.utils.profiling import span

VIT_VARIANTS = {"vit_l": {"width": 768, "depth": 24, "heads": 8, "mlp": 3072, "patch": 9}}
CROP = 112
LN_EPS = 1e-5
BN_EPS = 2e-5
FUSED = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION]


def _normal(rng, shape, std: float) -> np.ndarray:
    x = rng.standard_normal(shape, dtype=np.float32)
    x *= std
    return x


def init_vit(rng_or_seed=0, variant: str = "vit_l", embed_dim: int = 512, **sizes) -> dict:
    """Seeded numpy tree in the file's layouts: the patch conv HWIO, dense
    weights [in, out] (He normal, as the repository's other nets), biases
    and LN betas 0, LN gammas 1, pos_embed N(0, 0.02), the BN1d units at
    identity. ``sizes`` (width, depth, mlp, patch) override the
    variant's; small ones are for tests."""
    if variant not in VIT_VARIANTS:
        raise ValueError(f"unknown variant {variant}; options: {sorted(VIT_VARIANTS)}")
    s = {**VIT_VARIANTS[variant], **sizes}
    w, p, mlp = s["width"], s["patch"], s["mlp"]
    tokens = (CROP // p) ** 2
    rng = nn.as_rng(rng_or_seed)

    def dense(cin, cout, bias=True):
        out = {"w": _normal(rng, (cin, cout), math.sqrt(2.0 / cin))}
        if bias:
            out["b"] = np.zeros((cout,), np.float32)
        return out

    def ln(c):
        return {"gamma": np.ones((c,), np.float32), "beta": np.zeros((c,), np.float32)}

    params = {
        "patch_embed": {"w": _normal(rng, (p, p, 3, w), math.sqrt(2.0 / (p * p * 3))),
                        "b": np.zeros((w,), np.float32)},
        "pos_embed": _normal(rng, (tokens, w), 0.02),
        "blocks": [],
    }
    for _ in range(s["depth"]):
        params["blocks"].append({
            "ln1": ln(w), "qkv": dense(w, 3 * w, bias=False), "proj": dense(w, w),
            "ln2": ln(w), "fc1": dense(w, mlp), "fc2": dense(mlp, w),
        })
    params["norm"] = ln(w)
    params["head"] = {"fc1": dense(tokens * w, w, bias=False), "bn1": nn.bn_init(w),
                      "fc2": dense(w, embed_dim, bias=False), "bn2": nn.bn_init(embed_dim)}
    return params


def _patch_matrix(p: dict, dtype: torch.dtype) -> torch.Tensor:
    """The patch conv's OIHW weight as [out, kh * kw * cin], the order of a
    patch's pixels, in ``dtype``; cached beside ``nn._cast``'s casts."""
    cache = p.setdefault("_cast", {})
    if ("patches", dtype) not in cache:
        w = p["w"]
        cache[("patches", dtype)] = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1).to(dtype)
    return cache[("patches", dtype)]


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """[K, 112, 112, 3] -> [K, T, patch * patch * 3]: the patches of rows
    and columns 0 to (112 // patch) * patch - 1, row-major, each in
    (row, column, channel) order."""
    k, g = x.shape[0], CROP // patch
    cut = g * patch
    t = x[:, :cut, :cut].reshape(k, g, patch, g, patch, 3).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(k, g * g, patch * patch * 3)


def vit_forward(params: dict, x: torch.Tensor, heads: int = VIT_VARIANTS["vit_l"]["heads"]):
    """x: [K, 112, 112, 3] normalized crops, NHWC, in the compute dtype.
    Returns [K, D] unit float32 embeddings."""
    pe = params["patch_embed"]
    blocks = params["blocks"]
    kk = x.shape[0]
    width, patch = pe["w"].shape[0], pe["w"].shape[2]
    t = patchify(x, patch)
    y = F.linear(t, _patch_matrix(pe, x.dtype), nn._cast(pe, "b", x.dtype))
    # y: the residual stream; u: the LN of it that the next linear reads
    y, u = add_ln_cuda.add_ln(y, nn._cast(params, "pos_embed", x.dtype), blocks[0]["ln1"], LN_EPS)
    tokens, hd = y.shape[1], width // heads
    for i, b in enumerate(blocks):
        last = i + 1 == len(blocks)
        with span("frp.vit.attn"):
            qkv = nn.linear(b["qkv"], u)
            qkv = qkv.view(kk, tokens, 3, heads, hd).permute(2, 0, 3, 1, 4)
            with span("frp.vit.sdpa"), sdpa_kernel(FUSED, set_priority=True):
                o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
            o = o.transpose(1, 2).reshape(kk, tokens, width)
            y, u = add_ln_cuda.add_ln(y, nn.linear(b["proj"], o), b["ln2"], LN_EPS)
        with span("frp.vit.mlp"):
            h = nn.linear(b["fc1"], u)
            y, u = add_ln_cuda.add_ln(y, nn.linear(b["fc2"], F.relu6(h, inplace=True)),
                                      params["norm"] if last else blocks[i + 1]["ln1"], LN_EPS,
                                      last=last)
    head = params["head"]
    z = nn.linear(head["fc1"], u.reshape(kk, tokens * width))
    z = nn.batch_norm(head["bn1"], z.to(torch.float32), eps=BN_EPS)
    z = nn.linear(head["fc2"], z.to(x.dtype))
    z = nn.batch_norm(head["bn2"], z.to(torch.float32), eps=BN_EPS)
    return nn.l2_normalize(z)
