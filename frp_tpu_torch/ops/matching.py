"""Gallery matching (port of ``frp_tpu/ops/matching.py``): euclidean
distances through one matrix product, and an exact top-k whose tie order is
``lax.top_k``'s (lower gallery index first). The JAX package's two-stage
chunked top-k for large galleries (``_exact_topk``) works around the TPU's
``lax.top_k``; here one stable sort gives the same answer."""

from __future__ import annotations

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
    dist = torch.where(gallery_valid[None, :], dist, dist.new_tensor(1e6))
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
