"""5-point similarity-transform face alignment (port of
``frp_tpu/ops/align.py``).

``similarity_transform`` is the closed-form least-squares similarity from the
detected landmarks to the ArcFace 112x112 template; ``warp_crops_batched``
inverts it and samples the crops through ``ops/align_cuda.py`` (the CUDA
kernel on the card, its plain version on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from frp_tpu_torch.ops import align_cuda

# Canonical ArcFace 112x112 landmark template (left eye, right eye, nose,
# left mouth, right mouth).
ARCFACE_TEMPLATE_112 = np.array(
    [
        [38.2946, 51.6963],
        [73.5318, 51.5014],
        [56.0252, 71.7366],
        [41.5493, 92.3655],
        [70.7299, 92.2041],
    ],
    dtype=np.float32,
)


def _rot_t(a: torch.Tensor, b: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    """[[a, -b, tx], [b, a, ty]] stacked to [..., 2, 3]."""
    row0 = torch.stack([a, -b, tx], dim=-1)
    row1 = torch.stack([b, a, ty], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def similarity_transform(src: torch.Tensor, dst) -> torch.Tensor:
    """LSQ similarity mapping src [..., P, 2] onto dst ([P, 2] or
    broadcastable). Returns [..., 2, 3] M with dst ~= M[:, :2] @ src + M[:, 2]."""
    src = src.to(torch.float32)
    dst = torch.as_tensor(dst, dtype=torch.float32, device=src.device).expand(src.shape)
    mu_s = src.mean(dim=-2, keepdim=True)
    mu_d = dst.mean(dim=-2, keepdim=True)
    sc = src - mu_s
    dc = dst - mu_d
    var_s = torch.clamp((sc * sc).sum(dim=(-2, -1)), min=1e-12)
    a = (sc * dc).sum(dim=(-2, -1)) / var_s
    b = (sc[..., 0] * dc[..., 1] - sc[..., 1] * dc[..., 0]).sum(dim=-1) / var_s
    ms, md = mu_s[..., 0, :], mu_d[..., 0, :]
    tx = md[..., 0] - (a * ms[..., 0] + -b * ms[..., 1])
    ty = md[..., 1] - (b * ms[..., 0] + a * ms[..., 1])
    return _rot_t(a, b, tx, ty)


def invert_similarity(m: torch.Tensor) -> torch.Tensor:
    """Invert [..., 2, 3] similarity matrices (closed form)."""
    a = m[..., 0, 0]
    b = m[..., 1, 0]
    det = torch.clamp(a * a + b * b, min=1e-12)
    ia = a / det
    ib = -b / det
    tx, ty = m[..., 0, 2], m[..., 1, 2]
    itx = -(ia * tx + -ib * ty)
    ity = -(ib * tx + ia * ty)
    return _rot_t(ia, ib, itx, ity)


def warp_crops_batched(frames: torch.Tensor, matrices: torch.Tensor, out_size: int = 112) -> torch.Tensor:
    """frames [B, H, W, 3] (uint8 on the card), forward similarities
    [B, M, 2, 3] (source px -> output px) -> [B, M, S, S, 3] f32 crops."""
    return align_cuda.warp_crops(frames, invert_similarity(matrices), out_size)
