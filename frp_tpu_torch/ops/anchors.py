"""RetinaFace anchor (prior box) generation.

Replaces the anchor machinery hidden inside InsightFace's ONNX RetinaFace
(reference ``backend/app/utils/deepfake_utils.py:39-54`` uses ``FaceAnalysis``
with a 640x640 det size). Anchors are a pure function of the static detector
input size, so we build them **once in numpy at trace time** and bake them into
the jitted graph as constants — no dynamic shapes, XLA folds them into HBM.

Standard RetinaFace-mobilenet0.25 configuration: three FPN strides {8, 16, 32},
two square anchor scales per cell, variances (0.1, 0.2).

The PyTorch port's copy of ``frp_tpu/ops/anchors.py``; the anchors are
held bit-equal to the JAX package's by tests/test_torch_host.py.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

RETINAFACE_CFG = {
    "min_sizes": ((16, 32), (64, 128), (256, 512)),
    "steps": (8, 16, 32),
    "variances": (0.1, 0.2),
}


@lru_cache(maxsize=8)
def generate_anchors(image_size: int = 640) -> np.ndarray:
    """Return priors [A, 4] in normalized (cx, cy, w, h), float32.

    For image_size=640 -> A = 2*(80^2 + 40^2 + 20^2) = 16800 anchors.
    """
    min_sizes = RETINAFACE_CFG["min_sizes"]
    steps = RETINAFACE_CFG["steps"]
    anchors = []
    for k, step in enumerate(steps):
        fm = math.ceil(image_size / step)
        sizes = min_sizes[k]
        # vectorized grid per level
        jj, ii = np.meshgrid(np.arange(fm), np.arange(fm))  # ii=row(y), jj=col(x)
        cx = (jj.reshape(-1, 1) + 0.5) * step / image_size
        cy = (ii.reshape(-1, 1) + 0.5) * step / image_size
        for ms in sizes:
            s = ms / image_size
            level = np.concatenate(
                [cx, cy, np.full_like(cx, s), np.full_like(cx, s)], axis=1
            )
            anchors.append(level.reshape(fm, fm, 1, 4))
        # interleave the per-cell anchors the standard way: (row, col, anchor)
    out = []
    idx = 0
    for k, step in enumerate(steps):
        fm = math.ceil(image_size / step)
        n = len(min_sizes[k])
        level = np.concatenate(anchors[idx : idx + n], axis=2)  # [fm, fm, n, 4]
        out.append(level.reshape(-1, 4))
        idx += n
    return np.concatenate(out, axis=0).astype(np.float32)


def num_anchors(image_size: int = 640) -> int:
    return generate_anchors(image_size).shape[0]
