"""Gallery matching (port of ``frp_tpu/ops/matching.py``): euclidean
distances through one matrix product, and an exact top-k whose tie order is
``lax.top_k``'s (lower gallery index first). The JAX package's two-stage
chunked top-k for large galleries (``_exact_topk``) works around the TPU's
``lax.top_k``; here one stable sort gives the same answer. The host-side
confidence helpers the platform's face service and alerts use are copied
as they are."""

from __future__ import annotations

import numpy as np
import torch

from frp_tpu_torch.ops.topk import top_k as _top_k


def pairwise_euclidean(queries: torch.Tensor, gallery: torch.Tensor) -> torch.Tensor:
    """[B, D] x [N, D] -> [B, N] via ||q||^2 + ||g||^2 - 2 q.g."""
    q2 = (queries * queries).sum(dim=-1, keepdim=True)  # [B, 1]
    g2 = (gallery * gallery).sum(dim=-1)  # [N]
    qg = torch.matmul(queries, gallery.T)
    d2 = q2 + g2[None, :] - 2.0 * qg
    return torch.sqrt(torch.clamp(d2, min=0.0))


def gallery_match(
    queries: torch.Tensor,
    gallery: torch.Tensor,
    gallery_valid: torch.Tensor,
    tolerance: float = 0.6,
    top_k: int = 5,
):
    """Match queries [B, D] against the padded gallery [N, D] with validity
    [N]. Returns dict distances [B, N], best_idx [B] int32, best_distance
    [B], is_match [B], topk_idx [B, K] int32, topk_distance [B, K]."""
    dist = pairwise_euclidean(queries, gallery)
    # a Python scalar, not a new tensor: a tensor made from a host value is
    # copied to the card, and that copy waits for it
    dist = torch.where(gallery_valid[None, :], dist, 1e6)
    k = min(top_k, gallery.shape[0])
    neg_top, top_idx = _top_k(-dist, k)
    top_idx = top_idx.to(torch.int32)
    best_distance = -neg_top[:, 0]
    return {
        "distances": dist,
        "best_idx": top_idx[:, 0],
        "best_distance": best_distance,
        "is_match": best_distance <= tolerance,
        "topk_idx": top_idx,
        "topk_distance": -neg_top,
    }


# ---------------------------------------------------------------------------
# Host-side calibration helpers (exact reference formulas; cheap scalar math)
# ---------------------------------------------------------------------------

def confidence_level(distance: float) -> str:
    """Reference ``face_service.py:486-492``."""
    if distance < 0.4:
        return "high"
    if distance < 0.6:
        return "medium"
    return "low"


def calibrate_confidence(distance: float) -> float:
    """Reference ``face_service.py:497-506``: sigmoid k=12 centered at 0.5."""
    x = max(0.0, min(1.0, 1.0 - float(distance)))
    return round(float(100.0 / (1.0 + np.exp(-12.0 * (x - 0.5)))), 2)


def find_k_nearest(distances: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k smallest distances, ascending (reference
    ``face_service.py:590-612`` argpartition+sort semantics)."""
    k = min(k, len(distances))
    if k <= 0:
        return np.array([], dtype=np.int64)
    idx = np.argpartition(distances, k - 1)[:k]
    return idx[np.argsort(distances[idx])]
