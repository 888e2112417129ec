"""Fixed-shape greedy NMS with padded output slots (port of
``frp_tpu/ops/nms.py``).

The top ``pre_topk`` candidates by score (stable sort: lower index first on
ties, as ``lax.top_k``) get a dense [K, K] effective-overlap matrix; the
greedy pass keeps a candidate when no alive higher-ranked candidate
overlaps it above 1.0; kept candidates fill ``max_out`` padded slots in rank
order with a validity mask. The greedy pass runs in the CUDA kernel of
``ops/nms_cuda.py`` for tensors on the card, and in its plain PyTorch
version for tensors on the CPU.
"""

from __future__ import annotations

import torch

from frp_tpu_torch.ops import nms_cuda
from frp_tpu_torch.ops.topk import top_k


def overlap_matrix(
    boxes: torch.Tensor, iou_thresh: float, iom_thresh: float
) -> torch.Tensor:
    """Pairwise *effective* overlap [..., K, K] of boxes [..., K, 4] xyxy,
    normalized so the greedy pass suppresses at ``> 1.0``:
    max(IoU/iou_thresh, IoM/iom_thresh), where IoM is the intersection over
    the smaller box's area. ``iom_thresh <= 0`` disables the IoM term."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    iw = torch.clamp(ix2 - ix1, min=0.0)
    ih = torch.clamp(iy2 - iy1, min=0.0)
    inter = iw * ih
    union = area[..., :, None] + area[..., None, :] - inter
    eff = inter / torch.clamp(union, min=1e-12) / iou_thresh
    if iom_thresh > 0.0:
        min_area = torch.minimum(area[..., :, None], area[..., None, :])
        iom = inter / torch.clamp(min_area, min=1e-12)
        eff = torch.maximum(eff, iom / iom_thresh)
    return eff


def _select_slots(keep, top_scores, top_boxes, top_ldm, max_out: int, k: int):
    """Batched slot selection: [B, K] keep mask and rank-ordered candidates
    -> dict of [B, max_out] padded outputs. Kept candidates outrank the rest
    regardless of score (scores clamped to [0, 1] in the key); validity
    comes from the keep mask."""
    sort_key = keep.to(torch.float32) * 2.0 + torch.clamp(top_scores, 0.0, 1.0)
    kept = keep
    if max_out > k:  # fewer candidates than output slots: pad the pool
        pad = max_out - k
        b = keep.shape[0]
        sort_key = torch.cat([sort_key, sort_key.new_zeros(b, pad)], dim=1)
        kept = torch.cat([kept, kept.new_zeros(b, pad)], dim=1)
        top_scores = torch.cat([top_scores, top_scores.new_zeros(b, pad)], dim=1)
        top_boxes = torch.cat([top_boxes, top_boxes.new_zeros(b, pad, 4)], dim=1)
        top_ldm = torch.cat(
            [top_ldm, top_ldm.new_zeros(b, pad, top_ldm.shape[-1])], dim=1)
    _, out_idx = top_k(sort_key, max_out)
    out_boxes = torch.gather(top_boxes, 1, out_idx[..., None].expand(-1, -1, 4))
    out_ldm = torch.gather(
        top_ldm, 1, out_idx[..., None].expand(-1, -1, top_ldm.shape[-1]))
    valid = torch.gather(kept, 1, out_idx)
    out_scores = torch.where(
        valid, torch.gather(top_scores, 1, out_idx), top_scores.new_zeros(()))
    return {
        "boxes": torch.where(valid[..., None], out_boxes, out_boxes.new_zeros(())),
        "scores": out_scores,
        "landmarks": torch.where(valid[..., None], out_ldm, out_ldm.new_zeros(())),
        "valid": valid,
        "count": valid.sum(dim=1, dtype=torch.int32),
    }


def nms_padded_batched(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    landmarks: torch.Tensor,
    *,
    pre_topk: int = 256,
    max_out: int = 16,
    conf_thresh: float = 0.5,
    iou_thresh: float = 0.4,
    iom_thresh: float = 0.5,
):
    """Batched greedy NMS over boxes [B, A, 4], scores [B, A], landmarks
    [B, A, 10]. Returns dict boxes [B, M, 4], scores [B, M], landmarks
    [B, M, 10], valid [B, M] bool, count [B] int32 (padded slots zero).

    The greedy pass is ``nms_cuda.greedy_suppress`` (kernel on the card,
    plain version on the CPU)."""
    b, a = scores.shape
    k = min(pre_topk, a)
    top_scores, top_idx = top_k(scores, k)  # [B, K]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_ldm = torch.gather(
        landmarks, 1, top_idx[..., None].expand(-1, -1, landmarks.shape[-1]))
    eff = overlap_matrix(top_boxes, iou_thresh, iom_thresh)  # [B, K, K]
    above = top_scores >= conf_thresh
    keep = nms_cuda.greedy_suppress(eff, above, 1.0)
    return _select_slots(keep, top_scores, top_boxes, top_ldm, max_out, k)
