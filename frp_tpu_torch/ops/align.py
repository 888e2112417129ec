"""5-point similarity-transform face alignment (port of
``frp_tpu/ops/align.py``).

``similarity_transform`` is the closed-form least-squares similarity from the
detected landmarks to the ArcFace 112x112 template; ``warp_crops_batched``
inverts it and samples the crops through ``ops/align_cuda.py`` (the CUDA
kernel on the card, its plain version on the CPU). ``warp_crops`` (faces of
any frames, picked by index) and ``bbox_crop_matrices`` (square bbox crops)
are the JAX module's plain functions, on any device.
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


def bbox_crop_matrices(boxes: torch.Tensor, out_size: int) -> torch.Tensor:
    """Similarity matrices mapping a bbox crop onto [0, out_size)^2: boxes
    [..., 4] xyxy -> [..., 2, 3]. The longer side fills the crop, centred
    (the crop of the square around the box, resized)."""
    boxes = boxes.to(torch.float32)
    x1, y1, x2, y2 = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    w = torch.clamp(x2 - x1, min=1e-3)
    h = torch.clamp(y2 - y1, min=1e-3)
    s = out_size / torch.maximum(w, h)
    cx = (x1 + x2) / 2.0
    cy = (y1 + y2) / 2.0
    zeros = torch.zeros_like(s)
    row0 = torch.stack([s, zeros, out_size / 2.0 - s * cx], dim=-1)
    row1 = torch.stack([zeros, s, out_size / 2.0 - s * cy], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _bilinear_sample(frame: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Sample frame [H, W, C] at float coords xs, ys [S, S] -> [S, S, C] f32.
    The coordinates are clamped to the border in float space before the
    integer conversion (degenerate transforms of padded slots reach ~1e12,
    past any integer type), x0 = min(floor, w-2), and the weights are taken
    against the clamped index, so a sample at or past the edge returns the
    border pixel: the semantics of the warp kernel's plain version."""
    h, w = frame.shape[0], frame.shape[1]
    xs = torch.clamp(xs, 0.0, float(w - 1))
    ys = torch.clamp(ys, 0.0, float(h - 1))
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), max=w - 2)
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), max=h - 2)
    wx = (xs - x0.to(torch.float32))[..., None]
    wy = (ys - y0.to(torch.float32))[..., None]
    flat = frame.reshape(h * w, -1).to(torch.float32)

    def gather(yi, xi):
        return flat[yi * w + xi]

    top = gather(y0, x0) * (1 - wx) + gather(y0, x0 + 1) * wx
    bot = gather(y0 + 1, x0) * (1 - wx) + gather(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def warp_crops(frames: torch.Tensor, matrices: torch.Tensor, frame_idx: torch.Tensor,
               out_size: int = 112) -> torch.Tensor:
    """Inverse-warp crops of faces from any frames: frames [F, H, W, C],
    forward similarities [N, 2, 3] (source px -> output px), frame_idx [N]
    (the frame of each face) -> [N, S, S, C] f32 bilinear crops, sampled at
    the output pixel centres."""
    inv = invert_similarity(matrices.to(torch.float32))  # output px -> source px
    grid = torch.arange(out_size, dtype=torch.float32, device=frames.device) + 0.5
    gy, gx = torch.meshgrid(grid, grid, indexing="ij")
    crops = []
    for minv, fidx in zip(inv, frame_idx.to(torch.int64).tolist()):
        sx = minv[0, 0] * gx + minv[0, 1] * gy + minv[0, 2]
        sy = minv[1, 0] * gx + minv[1, 1] * gy + minv[1, 2]
        crops.append(_bilinear_sample(frames[fidx], sx - 0.5, sy - 0.5))
    if not crops:
        return torch.zeros((0, out_size, out_size, frames.shape[-1]), device=frames.device)
    return torch.stack(crops)
