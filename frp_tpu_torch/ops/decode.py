"""Box and landmark decoding for RetinaFace head outputs (port of
``frp_tpu/ops/decode.py``).

Conventions (standard RetinaFace):
    priors:   [..., A, 4]  normalized (cx, cy, w, h)
    loc:      [..., A, 4]   box regression deltas
    ldm:      [..., A, 10]  5-point landmark deltas
    variances: (0.1, 0.2)
"""

from __future__ import annotations

import torch

from frp_tpu_torch.ops.anchors import RETINAFACE_CFG


def decode_boxes(loc: torch.Tensor, priors: torch.Tensor, image_size: float = 1.0) -> torch.Tensor:
    """Decode box deltas -> [..., A, 4] (x1, y1, x2, y2) scaled by image_size."""
    v0, v1 = RETINAFACE_CFG["variances"]
    cxy = priors[..., :2] + loc[..., :2] * v0 * priors[..., 2:]
    wh = priors[..., 2:] * torch.exp(loc[..., 2:] * v1)
    tl = cxy - wh / 2.0
    br = cxy + wh / 2.0
    return torch.cat([tl, br], dim=-1) * image_size


def decode_landmarks(ldm: torch.Tensor, priors: torch.Tensor, image_size: float = 1.0) -> torch.Tensor:
    """Decode 5-point landmark deltas -> [..., A, 10] (x1,y1,...,x5,y5)."""
    v0, _ = RETINAFACE_CFG["variances"]
    pts = ldm.reshape(*ldm.shape[:-1], 5, 2)
    out = priors[..., None, :2] + pts * v0 * priors[..., None, 2:]
    return out.reshape(*ldm.shape[:-1], 10) * image_size
