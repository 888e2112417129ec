"""Seeded weights for a configuration whose public checkpoint cannot be
fetched here: drawn on the card from the run's seed in two calls (one
normal draw for every weight, one uniform draw for every batch-norm and
PReLU value), float32 as the engine's loader reads them, and written as a
weights file of flat ``a/b/0/w`` keys in the layouts of the shipped files.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import embedders
from perfbench.reference.nets import IRESNET_DEPTHS

KINDS = ("conv", "dense", "gamma", "beta", "mean", "var", "alpha", "zero")
WIDTHS = (64, 128, 256, 512)


def iresnet_leaves(arch: str, embed_dim: int) -> dict:
    """{key: (shape, kind)} of an iresnet tree; kind is "conv" (HWIO, He
    normal), "dense", "gamma", "beta", "mean", "var", "alpha" or "zero"."""
    out: dict = {}

    def bn(prefix, c):
        for k in ("gamma", "beta", "mean", "var"):
            out[f"{prefix}/{k}"] = ((c,), k)

    out["stem/w"] = ((3, 3, 3, 64), "conv")
    bn("stem_bn", 64)
    out["stem_prelu/alpha"] = ((64,), "alpha")
    cin = 64
    for si, (width, n) in enumerate(zip(WIDTHS, IRESNET_DEPTHS[arch])):
        for b in range(n):
            p = f"stages/{si}/{b}"
            bn(f"{p}/bn1", cin)
            out[f"{p}/conv1/w"] = ((3, 3, cin, width), "conv")
            bn(f"{p}/bn2", width)
            out[f"{p}/prelu/alpha"] = ((width,), "alpha")
            out[f"{p}/conv2/w"] = ((3, 3, width, width), "conv")
            bn(f"{p}/bn3", width)
            if b == 0:
                out[f"{p}/down_conv/w"] = ((1, 1, cin, width), "conv")
                bn(f"{p}/down_bn", width)
            cin = width
    bn("head_bn", cin)
    out["fc/w"] = ((cin * 7 * 7, embed_dim), "dense")
    out["fc/b"] = ((embed_dim,), "zero")
    bn("feat_bn", embed_dim)
    return out


def _numel(shape) -> int:
    return int(np.prod(shape))


def draw(leaves: dict, seed: int, device) -> dict:
    """{key: float32 numpy array} drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    keys = sorted(leaves)
    n_norm = sum(_numel(leaves[k][0]) for k in keys if leaves[k][1] in ("conv", "dense", "beta", "mean"))
    n_unif = sum(_numel(leaves[k][0]) for k in keys if leaves[k][1] in ("gamma", "var", "alpha"))
    normal = torch.randn(n_norm, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device)
    out, i, j = {}, 0, 0
    for k in keys:
        shape, kind = leaves[k]
        n = _numel(shape)
        if kind in ("conv", "dense", "beta", "mean"):
            x = normal[i:i + n].reshape(shape)
            i += n
            if kind == "conv":
                x = x * math.sqrt(2.0 / (shape[0] * shape[1] * shape[2]))
            elif kind == "dense":
                x = x * math.sqrt(2.0 / shape[0])
            else:
                x = x * 0.1
        elif kind in ("gamma", "var", "alpha"):
            u = unif[j:j + n].reshape(shape)
            j += n
            x = 0.15 + 0.2 * u if kind == "alpha" else 0.8 + 0.4 * u
        else:
            x = torch.zeros(shape, device=device)
        out[k] = x
    flat = torch.cat([out[k].reshape(-1) for k in keys]).cpu().numpy()
    res, at = {}, 0
    for k in keys:
        n = _numel(leaves[k][0])
        res[k] = flat[at:at + n].reshape(leaves[k][0])
        at += n
    return res


def write_seeded(path: str, spec: dict, seed: int, device) -> None:
    """The weights file of ``spec``'s arch and embedding width, its leaves
    from the arch's reference embedder (``reference/embedders``)."""
    arch = spec["arch"]
    leaves_of = embedders.resolve(arch).leaves
    if leaves_of is None:
        raise SystemExit(f"no seeded weights can be drawn for arch {arch!r}")
    leaves = leaves_of(arch, spec["embed_dim"])
    odd = sorted(k for k, (_, kind) in leaves.items() if kind not in KINDS)
    if odd:
        raise SystemExit(f"arch {arch!r}: leaves {odd} are of no kind in {KINDS}")
    arrays = draw(leaves, seed, device)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
