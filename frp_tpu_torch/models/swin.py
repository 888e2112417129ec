"""SwinFace's Swin-T face embedder in PyTorch: the recognition backbone of
SwinFace (Qin et al., arXiv:2308.11509, github.com/lxq1000/SwinFace), which
runs the Swin Transformer (Liu et al., arXiv:2103.14030;
microsoft/Swin-Transformer ``swin_tiny_patch4_window7_224``) on 112 x 112
face crops at patch 2, so that its grids are Swin-T's 56/28/14/7.

    crop [K, 112, 112, 3] -> 2x2 patches at stride 2 (3136 of 12 values)
      -> a GEMM with the conv's HWIO weight seen as [12, 96], + bias -> LN
    stage s = 1..4: width C = 96, 192, 384, 768, blocks 2, 2, 6, 2, heads
      C / 32, window 7 (49 tokens), grid 56, 28, 14, 7; block i (from 0):
      shift = 3 where i is odd and the grid is larger than the window, else 0
      u = LN1(x) rolled by (-shift, -shift) on the grid, cut into 7x7 windows
      a = softmax(q k^T / sqrt(32) + B[rel_index] + mask_shift) v
        qkv C -> 3C with bias; B a learned table [169, heads], rel_index[i, j]
        = (dy + 6) * 13 + (dx + 6) for token i's coordinate minus token j's;
        mask_shift -100 between tokens of different regions of the rolled
        grid, in shifted blocks only
      x = x + roll_back(windows_back(proj(a)))
      x = x + fc2(GELU(fc1(LN2(x))))           MLP 4C, exact (erf) GELU
    between stages, patch merging: [x(0::2, 0::2), x(1::2, 0::2),
      x(0::2, 1::2), x(1::2, 1::2)] (row, column) joined to 4C -> LN(4C)
      -> Linear 4C -> 2C without bias
    final LN(768) (float32) -> mean over the 49 tokens -> Linear 768 -> 768
      (no bias) -> BN1d -> Linear embed_dim (no bias) -> BN1d -> L2

LayerNorm eps 1e-5 (nn.LayerNorm's), the head's BN1d eps 2e-5. The linears
run in the compute dtype with the bias inside the GEMM. The residual
stream is [K x grid^2, C] in grid order. Each residual add runs with the LN
that reads its sum in one ``ops/add_ln_cuda.add_ln`` call: the attention
add with LN2, each fc2 add with the next block's LN1, and stage 4's last
add with the final LN (``last=True``: float32 statistics, as ``vit.py``).
A stage's last fc2 add feeds patch merging, whose LN is over 4C of
gathered tokens and reads no sum: that add is a plain add, and the next
stage's first LN1 runs eager on the merge's output, as the patch LN and
block 0's LN1.

Each block's roll and window cut are one row gather (``index_select``)
and the reverse with the roll back another. The windows of a block are ordered by their shift mask (in a
shifted block the windows inside the grid, those of its last column, of
its last row, and the corner), and within one mask face by face, so that
the windows of one mask are one run of rows: each run is one attention
call (or more, of at most ``MAX_WINDOWS`` windows each) whose bias, B plus
that mask, is one [1, heads, 49, 49] tensor that the call broadcasts over
the run's windows. The biases are built from the tables once a dtype and
cached on the block (as ``nn._cast`` caches casts), each stored with rows of
56 so that the fused kernel reads it without a padded copy: heads x 5.5 KB a
mask, 1.5 MB in all for Swin-T in bf16. The gathers' indices are built on
the device in each call from patterns cached once a grid and shift (a
window's positions, a position's window rank and slot), so that nothing
cached grows with the batch sizes an engine sees.

**Stated departures**: B plus the mask are added to the scores in the
compute dtype (bf16: -100 + B rounds to about 0.5); the attention reads q,
k and v in the compute dtype, with float32 softmax statistics and
accumulation inside the fused kernel, where the source runs in float32;
the head (Linear, BN1d, Linear, BN1d on the pooled token, arcface_torch's
form as in ``vit.py``) is assumed: SwinFace's expression, age and
attribute subnets are left out, as the engine produces none of those
outputs. The attention is held to the fused backends that take a bias
(``BIASED``: memory-efficient, then cuDNN; on the CPU torch's flash
kernel, which takes one): a layout only the math backend takes raises.

Under a profiler each block opens ``frp.swin.attn`` (the gather, qkv, the
attention, proj, the reverse gather and the add with LN2), in it
``frp.swin.window`` around the roll and cut and again around the reverse
and roll back (neither in stage 4, whose grid is one window and needs no
gather) and ``frp.swin.sdpa`` around the block's attention calls, then
``frp.swin.mlp`` (fc1, GELU, fc2 and the add); each patch merging opens
``frp.swin.merge`` (the gather, LN(4C), the linear).

The parameter tree holds the file's layouts (``convert_params`` makes the
dense weights [out, in] and the patch conv OIHW). The head count of a
block is its table's second axis; the relative index, the masks and the
gathers' indices are derived, not weights.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from frp_tpu_torch.models import nn
from frp_tpu_torch.models.vit import CROP, _normal, _patch_matrix, patchify
from frp_tpu_torch.ops import add_ln_cuda
from frp_tpu_torch.utils.profiling import span

SWIN_VARIANTS = {"swin_t": {"patch": 2, "width": 96, "depths": (2, 2, 6, 2),
                            "heads": (3, 6, 12, 24), "window": 7, "mlp_ratio": 4}}
LN_EPS = 1e-5
BN_EPS = 2e-5
MASK = -100.0
BIASED = [SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION]
# (row, column) offsets of patch merging's x0, x1, x2, x3
MERGE = ((0, 0), (1, 0), (0, 1), (1, 1))
_ALIGN = 8  # elements: the fused kernel's stride alignment for a bias
# windows an attention call takes at most: the fused kernel's grid holds a
# window a block along its third axis, which holds 65535
MAX_WINDOWS = 65535


def init_swin(rng_or_seed=0, variant: str = "swin_t", embed_dim: int = 512, **sizes) -> dict:
    """Seeded numpy tree in the file's layouts: the patch conv HWIO, dense
    weights [in, out] (He normal, as the repository's other nets), biases
    and LN betas 0, LN gammas 1, the relative-position tables N(0, 0.02),
    the BN1d units at identity. ``sizes`` (patch, width, depths, heads,
    window, mlp_ratio) override the variant's; small ones are for tests."""
    if variant not in SWIN_VARIANTS:
        raise ValueError(f"unknown variant {variant}; options: {sorted(SWIN_VARIANTS)}")
    s = {**SWIN_VARIANTS[variant], **sizes}
    p, c, win = s["patch"], s["width"], s["window"]
    rng = nn.as_rng(rng_or_seed)

    def dense(cin, cout, bias=True):
        out = {"w": _normal(rng, (cin, cout), math.sqrt(2.0 / cin))}
        if bias:
            out["b"] = np.zeros((cout,), np.float32)
        return out

    def ln(width):
        return {"gamma": np.ones((width,), np.float32), "beta": np.zeros((width,), np.float32)}

    params = {
        "patch_embed": {"w": _normal(rng, (p, p, 3, c), math.sqrt(2.0 / (p * p * 3))),
                        "b": np.zeros((c,), np.float32)},
        "patch_norm": ln(c),
        "stages": [],
    }
    for si, (depth, heads) in enumerate(zip(s["depths"], s["heads"])):
        width = c * 2 ** si
        hidden = width * s["mlp_ratio"]
        stage = {"blocks": [{
            "ln1": ln(width), "qkv": dense(width, 3 * width),
            "rel_bias": _normal(rng, ((2 * win - 1) ** 2, heads), 0.02),
            "proj": dense(width, width), "ln2": ln(width),
            "fc1": dense(width, hidden), "fc2": dense(hidden, width),
        } for _ in range(depth)]}
        if si + 1 < len(s["depths"]):
            stage["merge"] = {"norm": ln(4 * width), "reduction": dense(4 * width, 2 * width,
                                                                        bias=False)}
        params["stages"].append(stage)
    out = c * 2 ** (len(s["depths"]) - 1)
    params["norm"] = ln(out)
    params["head"] = {"fc1": dense(out, out, bias=False), "bn1": nn.bn_init(out),
                      "fc2": dense(out, embed_dim, bias=False), "bn2": nn.bn_init(embed_dim)}
    return params


def shift_of(grid: int, i: int, window: int) -> int:
    """Block i's cyclic shift: half a window in odd blocks, none where the
    grid is no larger than the window (Swin's one-window stage)."""
    return 0 if grid <= window or i % 2 == 0 else window // 2


def rolled(grid: int, shift: int) -> torch.Tensor:
    """[grid, grid]: the grid position (row * grid + column) that each
    position of the grid rolled by (-shift, -shift) holds."""
    a = (torch.arange(grid) + shift) % grid
    return a[:, None] * grid + a[None, :]


def shift_mask(grid: int, shift: int, window: int) -> torch.Tensor:
    """[windows, n, n] float32, Swin's ``attn_mask`` of the rolled grid: MASK
    between tokens of a window that lie in different regions (the rows and
    columns split at grid - window and grid - shift), 0 elsewhere; all 0
    without a shift."""
    nw = (grid // window) ** 2
    n = window * window
    if not shift:
        return torch.zeros(nw, n, n)
    cut = torch.tensor([grid - window, grid - shift])
    band = torch.bucketize(torch.arange(grid), cut, right=True)  # 0, 1, 2 along an axis
    region = band[:, None] * 3 + band[None, :]
    region = region.view(grid // window, window, grid // window, window).permute(0, 2, 1, 3)
    region = region.reshape(nw, n)
    return torch.where(region[:, None, :] != region[:, :, None], MASK, 0.0)


def _rel_index(window: int) -> torch.Tensor:
    """[n, n]: (dy + w - 1) * (2w - 1) + (dx + w - 1), (dy, dx) token i's
    coordinate minus token j's in a window of w x w."""
    ys, xs = torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    dy = ys[:, None] - ys[None, :] + window - 1
    dx = xs[:, None] - xs[None, :] + window - 1
    return dy * (2 * window - 1) + dx


def _layout(cache: dict, grid: int, shift: int, window: int):
    """(positions [windows, n] of each window's tokens in the grid, ordered
    by mask; each mask's window count; the masks [groups, n, n]), cached."""
    key = ("swin_layout", grid, shift, window)
    if key not in cache:
        nw1, n = grid // window, window * window
        pos = rolled(grid, shift).view(nw1, window, nw1, window).permute(0, 2, 1, 3)
        pos = pos.reshape(nw1 * nw1, n)
        masks = shift_mask(grid, shift, window)
        pats, which = torch.unique(masks.reshape(nw1 * nw1, -1), dim=0, return_inverse=True)
        order = torch.argsort(which, stable=True)
        cache[key] = (pos[order], torch.bincount(which).tolist(), pats.view(-1, n, n))
    return cache[key]


def _gather(cache: dict, kk: int, grid: int, shift: int, window: int, device):
    """(rows of the residual stream in window order, its inverse), or None
    where the grid is one unshifted window (the stream's own order). Only
    what does not depend on the batch size is cached: each window's grid
    positions, and each grid position's window rank (times n) and slot; the
    indices of a batch of kk faces are built from them on ``device``."""
    if grid == window and not shift:
        return None
    key = ("swin_order", grid, shift, window, str(device))
    if key not in cache:
        pos, _, _ = _layout(cache, grid, shift, window)
        n = window * window
        at = torch.empty(grid * grid, dtype=torch.long)
        at[pos.reshape(-1)] = torch.arange(pos.numel())
        cache[key] = tuple(t.to(device) for t in (pos[:, None, :], at // n * n, at % n))
    pos, rank_n, slot = cache[key]
    n = pos.shape[-1]
    # row (window, face, token) of the window order <- face * grid^2 + position
    idx = (torch.arange(0, kk * grid * grid, grid * grid, device=device)[:, None] + pos).reshape(-1)
    # row face * grid^2 + position of the stream <- (rank * kk + face) * n + slot
    inv = (torch.arange(0, kk * n, n, device=device)[:, None]
           + torch.add(slot, rank_n, alpha=kk)).reshape(-1)
    return idx, inv


def _biases(b: dict, cache: dict, grid: int, shift: int, window: int, dtype) -> list:
    """The attention bias of each run of windows, B[rel_index] plus its
    mask, [1, heads, n, n] in ``dtype``, each a view of rows padded to
    ``_ALIGN``; cached on the block."""
    own = b.setdefault("_cast", {})
    key = ("swin_bias", grid, shift, window, dtype)
    if key not in own:
        table = b["rel_bias"]
        n = window * window
        rel = table[_rel_index(window).to(table.device)].permute(2, 0, 1)  # [heads, n, n]
        _, _, masks = _layout(cache, grid, shift, window)
        full = torch.zeros(masks.shape[0], rel.shape[0], n, -(-n // _ALIGN) * _ALIGN,
                           dtype=dtype, device=table.device)
        full[..., :n] = (rel[None] + masks.to(table.device)[:, None]).to(dtype)
        own[key] = [full[g:g + 1, :, :, :n] for g in range(full.shape[0])]
    return own[key]


def _attention(b: dict, cache: dict, u: torch.Tensor, kk: int, grid: int, shift: int,
               window: int, gather) -> torch.Tensor:
    """proj(attention) of LN1's output u [K x grid^2, C], back in grid order;
    ``gather`` is ``_gather``'s pair for the grid and shift."""
    c, n = u.shape[-1], window * window
    heads = b["rel_bias"].shape[1]
    if gather is not None:
        with span("frp.swin.window"):
            u = u.index_select(0, gather[0])
    qkv = nn.linear(b["qkv"], u)
    _, counts, _ = _layout(cache, grid, shift, window)
    biases = _biases(b, cache, grid, shift, window, u.dtype)
    runs, at = [], 0
    with span("frp.swin.sdpa"), sdpa_kernel(BIASED, set_priority=True):
        for count, bias in zip(counts, biases):
            for part in range(0, count * kk, MAX_WINDOWS):
                rows = min(MAX_WINDOWS, count * kk - part) * n
                q, k, v = qkv[at:at + rows].view(-1, n, 3, heads, c // heads).unbind(2)
                o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                   v.transpose(1, 2), attn_mask=bias)
                runs.append((at, at + rows, o.transpose(1, 2).reshape(rows, c)))
                at += rows
    # each run's proj (nn.linear's GEMM with the bias) into its rows of one output
    d = torch.empty_like(u)
    w, bias = nn._cast(b["proj"], "w", u.dtype), nn._cast(b["proj"], "b", u.dtype)
    for r0, r1, o in runs:
        torch.addmm(bias, o, w.t(), out=d[r0:r1])
    if gather is not None:
        with span("frp.swin.window"):
            d = d.index_select(0, gather[1])
    return d


def _merge(m: dict, y: torch.Tensor, kk: int, grid: int) -> torch.Tensor:
    """Patch merging of the stream y [K x grid^2, C] -> [K x (grid / 2)^2, 2C]."""
    v = y.view(kk, grid, grid, -1)
    t = torch.cat([v[:, dy::2, dx::2] for dy, dx in MERGE], -1)
    t = t.reshape(kk * (grid // 2) ** 2, -1)
    return nn.linear(m["reduction"], nn.layer_norm(m["norm"], t, LN_EPS))


def swin_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [K, 112, 112, 3] normalized crops, NHWC, in the compute dtype.
    Returns [K, D] unit float32 embeddings."""
    pe = params["patch_embed"]
    stages = params["stages"]
    cache = params.setdefault("_cast", {})
    kk, patch = x.shape[0], pe["w"].shape[2]
    window = (math.isqrt(stages[0]["blocks"][0]["rel_bias"].shape[0]) + 1) // 2
    grid = CROP // patch
    t = patchify(x, patch).reshape(kk * grid * grid, -1)
    y = nn.layer_norm(params["patch_norm"],
                      F.linear(t, _patch_matrix(pe, x.dtype), nn._cast(pe, "b", x.dtype)), LN_EPS)
    # y: the residual stream; u: the LN of it that the next linear reads
    u = nn.layer_norm(stages[0]["blocks"][0]["ln1"], y, LN_EPS)
    for si, stage in enumerate(stages):
        blocks = stage["blocks"]
        # the gathers' indices, built once a forward for each shift of the stage
        shifts = [shift_of(grid, i, window) for i in range(len(blocks))]
        gathers = {s: _gather(cache, kk, grid, s, window, x.device) for s in set(shifts)}
        for i, b in enumerate(blocks):
            with span("frp.swin.attn"):
                d = _attention(b, cache, u, kk, grid, shifts[i], window, gathers[shifts[i]])
                y, u = add_ln_cuda.add_ln(y, d, b["ln2"], LN_EPS)
            with span("frp.swin.mlp"):
                d = nn.linear(b["fc2"], F.gelu(nn.linear(b["fc1"], u)))
                if i + 1 < len(blocks):
                    y, u = add_ln_cuda.add_ln(y, d, blocks[i + 1]["ln1"], LN_EPS)
                elif "merge" in stage:
                    y = y + d
                else:
                    _, u = add_ln_cuda.add_ln(y, d, params["norm"], LN_EPS, last=True)
        if "merge" in stage:
            with span("frp.swin.merge"):
                y = _merge(stage["merge"], y, kk, grid)
            grid //= 2
            u = nn.layer_norm(stages[si + 1]["blocks"][0]["ln1"], y, LN_EPS)
    head = params["head"]
    z = u.view(kk, grid * grid, -1).to(torch.float32).mean(1)
    z = nn.linear(head["fc1"], z.to(x.dtype))
    z = nn.batch_norm(head["bn1"], z.to(torch.float32), eps=BN_EPS)
    z = nn.linear(head["fc2"], z.to(x.dtype))
    z = nn.batch_norm(head["bn2"], z.to(torch.float32), eps=BN_EPS)
    return nn.l2_normalize(z)
