"""Device face-quality scores over padded detection slots (port of
``frp_tpu/ops/quality.py::assess_quality_batch``): the reference's 5-factor
weighted score, size .25 | position .20 | aspect .20 | blur .20 |
lighting .15, with blur and lighting taken on the aligned crop."""

from __future__ import annotations

import torch

_GRAY = (0.299, 0.587, 0.114)  # cv2 RGB2GRAY weights


def assess_quality_batch(
    crops: torch.Tensor,
    boxes: torch.Tensor,
    frame_hw: tuple[int, int],
    valid: torch.Tensor,
) -> dict:
    """crops [N, S, S, 3] float 0..255, boxes [N, 4] xyxy frame px, frame_hw
    (H, W), valid [N] bool -> dict of [N] float32 scores (padded slots 0)."""
    h, w = float(frame_hw[0]), float(frame_hw[1])
    x1, y1, x2, y2 = boxes.unbind(-1)
    fw = torch.clamp(x2 - x1, min=1.0)
    fh = torch.clamp(y2 - y1, min=1.0)
    size_ratio = (fw * fh) / (w * h)
    size_score = torch.clamp(size_ratio / 0.25 * 100.0, max=100.0)

    dcx = ((x1 + x2) / 2.0 - w / 2.0) / w
    dcy = ((y1 + y2) / 2.0 - h / 2.0) / h
    dist_center = torch.sqrt(dcx * dcx + dcy * dcy)
    position_score = torch.clamp((1.0 - dist_center) * 100.0, min=0.0)

    aspect = torch.minimum(fw, fh) / torch.maximum(fw, fh)
    aspect_score = aspect * 100.0

    gray = crops[..., 0] * _GRAY[0] + crops[..., 1] * _GRAY[1] + crops[..., 2] * _GRAY[2]
    # 5-point Laplacian, interior only
    lap = (
        gray[:, :-2, 1:-1]
        + gray[:, 2:, 1:-1]
        + gray[:, 1:-1, :-2]
        + gray[:, 1:-1, 2:]
        - 4.0 * gray[:, 1:-1, 1:-1]
    )
    lap_var = torch.var(lap, dim=(1, 2), correction=0)
    blur_score = torch.clamp(lap_var / 500.0 * 100.0, max=100.0)

    mean_b = gray.mean(dim=(1, 2))
    std_b = torch.std(gray, dim=(1, 2), correction=0)
    brightness = 100.0 - torch.abs(mean_b - 128.0) / 128.0 * 100.0
    contrast = torch.clamp(std_b / 50.0 * 100.0, max=100.0)
    lighting_score = (brightness + contrast) / 2.0

    overall = (
        size_score * 0.25
        + position_score * 0.2
        + aspect_score * 0.2
        + blur_score * 0.2
        + lighting_score * 0.15
    )
    mask = valid.to(torch.float32)
    return {
        "score": overall * mask,
        "size_score": size_score * mask,
        "position_score": position_score * mask,
        "aspect_score": aspect_score * mask,
        "blur_score": blur_score * mask,
        "lighting_score": lighting_score * mask,
    }
