"""On-device image preprocessing for the detection pipeline (port of
``frp_tpu/ops/image.py``). Frames stay NHWC at the public functions."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def preprocess_frames(frames: torch.Tensor, det_size: int = 640, dtype_name: str = "bfloat16"):
    """uint8 RGB frames [B, H, W, 3] -> (x [B, det, det, 3] normalized
    ((v - 127.5) / 128) in the compute dtype, scale [B, 2] (sx, sy) mapping
    detector px back to frame px).

    ``jax.image.resize(..., "bilinear")`` antialiases when it shrinks, so the
    resize is ``F.interpolate(..., antialias=True)``."""
    b, h, w, _ = frames.shape
    f = frames.to(torch.float32).permute(0, 3, 1, 2)
    resized = F.interpolate(
        f, size=(det_size, det_size), mode="bilinear", align_corners=False,
        antialias=True,
    ).permute(0, 2, 3, 1)
    x = ((resized - 127.5) / 128.0).to(getattr(torch, dtype_name))
    scale = torch.stack([
        torch.full((b,), w / det_size, dtype=torch.float32, device=frames.device),
        torch.full((b,), h / det_size, dtype=torch.float32, device=frames.device),
    ], dim=-1)
    return x, scale


def yuv420_to_rgb(yuv: torch.Tensor) -> torch.Tensor:
    """I420 planar frames [B, H*3//2, W] uint8 -> RGB [B, H, W, 3] float32
    (0..255), BT.601 studio swing (cv2's COLOR_BGR2YUV_I420 convention)."""
    b, h15, w = yuv.shape
    h = (h15 * 2) // 3
    y = yuv[:, :h, :].to(torch.float32)
    quarter = h // 4
    u = yuv[:, h : h + quarter, :].reshape(b, h // 2, w // 2).to(torch.float32)
    v = yuv[:, h + quarter :, :].reshape(b, h // 2, w // 2).to(torch.float32)
    # nearest 2x chroma upsample
    u = u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) - 128.0
    v = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) - 128.0
    yl = 1.164 * (y - 16.0)
    r = yl + 1.596 * v
    g = yl - 0.392 * u - 0.813 * v
    bl = yl + 2.017 * u
    return torch.clamp(torch.stack([r, g, bl], dim=-1), 0.0, 255.0)


_IMAGENET: dict = {}  # device -> (mean, std), made once per device


def normalize_imagenet(crops: torch.Tensor) -> torch.Tensor:
    """ImageNet normalization for the spoof classifier. crops: [..., 3] in 0..255."""
    consts = _IMAGENET.get(crops.device)
    if consts is None:
        mean = torch.tensor([0.485, 0.456, 0.406], dtype=torch.float32) * 255.0
        std = torch.tensor([0.229, 0.224, 0.225], dtype=torch.float32) * 255.0
        consts = _IMAGENET[crops.device] = (mean.to(crops.device), std.to(crops.device))
    mean, std = consts
    return (crops - mean) / std


def normalize_face(crops: torch.Tensor) -> torch.Tensor:
    """ArcFace-style normalization for the embedder: (v - 127.5) / 128."""
    return (crops - 127.5) / 128.0
