"""Face-quality scores (port of ``frp_tpu/ops/quality.py``): the reference's
5-factor weighted score, size .25 | position .20 | aspect .20 | blur .20 |
lighting .15, in two forms: ``assess_quality_batch`` over padded detection
slots on the device, with blur and lighting taken on the aligned crop, and
``assess_quality_host``, the numpy replica on the original-resolution crop
that the enrolment gate uses (copied as it is)."""

from __future__ import annotations

import numpy as np
import torch

_GRAY = (0.299, 0.587, 0.114)  # cv2 RGB2GRAY weights
_LAPLACIAN = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], dtype=np.float32)


def _issues(size_ratio, dist_center, aspect, blur_score, lighting_score):
    issues = []
    if size_ratio < 0.05:
        issues.append("Face too small - move closer or crop image")
    if size_ratio > 0.8:
        issues.append("Face too large - image should show some background")
    if dist_center > 0.4:
        issues.append("Face not centered - adjust framing")
    if aspect < 0.75:
        issues.append("Face appears distorted or at extreme angle")
    if blur_score < 40:
        issues.append("Image is blurry - use better focus or steady camera")
    if lighting_score < 40:
        issues.append("Poor lighting - improve lighting conditions")
    return issues


def assess_quality_host(image: np.ndarray, face_location) -> dict:
    """Exact reference formula replica. image: [H, W, 3] uint8 RGB.
    face_location: (top, right, bottom, left) — dlib ordering kept for parity.
    """
    top, right, bottom, left = face_location
    height, width = image.shape[:2]
    fw = max(1, right - left)
    fh = max(1, bottom - top)
    face_area = float(fw * fh)
    image_area = float(width * height)

    size_ratio = face_area / image_area if image_area > 0 else 0.0
    size_score = min(100.0, (size_ratio / 0.25) * 100.0)

    fcx, fcy = (left + right) / 2.0, (top + bottom) / 2.0
    icx, icy = width / 2.0, height / 2.0
    dist_center = (
        float(np.sqrt(((fcx - icx) / width) ** 2 + ((fcy - icy) / height) ** 2))
        if width and height
        else 0.0
    )
    position_score = max(0.0, (1.0 - dist_center) * 100.0)

    aspect = min(fw, fh) / max(fw, fh)
    aspect_score = aspect * 100.0

    crop = image[max(0, top):max(0, bottom), max(0, left):max(0, right)]
    if crop.size:
        gray = (
            crop[..., 0] * _GRAY[0] + crop[..., 1] * _GRAY[1] + crop[..., 2] * _GRAY[2]
        ).astype(np.float64)
        lap = _conv2_same(gray, _LAPLACIAN.astype(np.float64))
        blur_score = min(100.0, (float(lap.var()) / 500.0) * 100.0)
        mean_b, std_b = float(gray.mean()), float(gray.std())
        brightness_score = 100.0 - abs(mean_b - 128.0) / 128.0 * 100.0
        contrast_score = min(100.0, (std_b / 50.0) * 100.0)
        lighting_score = (brightness_score + contrast_score) / 2.0
    else:
        blur_score = 50.0
        lighting_score = 50.0

    overall = (
        size_score * 0.25
        + position_score * 0.2
        + aspect_score * 0.2
        + blur_score * 0.2
        + lighting_score * 0.15
    )
    return {
        "score": round(overall, 2),
        "size_score": round(size_score, 2),
        "position_score": round(position_score, 2),
        "aspect_score": round(aspect_score, 2),
        "blur_score": round(blur_score, 2),
        "lighting_score": round(lighting_score, 2),
        "issues": _issues(size_ratio, dist_center, aspect, blur_score, lighting_score),
    }


def _conv2_same(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """3x3 'same' convolution with edge replication (cv2 BORDER_REFLECT_101
    approximated by edge-pad; variance difference is negligible for the score)."""
    p = np.pad(img, 1, mode="edge")
    out = np.zeros_like(img)
    for dy in range(3):
        for dx in range(3):
            out += k[dy, dx] * p[dy : dy + img.shape[0], dx : dx + img.shape[1]]
    return out


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
