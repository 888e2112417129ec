"""Anchor-target assignment and box/landmark encoding for detector training
(port of ``frp_tpu/ops/anchor_targets.py``).

The exact inverse of ``ops/decode.py`` (the RetinaFace/SSD form, variances
0.1/0.2): every GT's best anchor is forced positive, and so is any anchor
with IoU >= pos_thresh. GT boxes arrive padded [B, G, 4] with a validity
mask; the outputs are per-anchor targets and labels (1 positive, 0
background, -1 ignore). The functions take a batch directly and equal the
JAX package's per-image results (which it maps over the batch with vmap).
"""

from __future__ import annotations

import torch

from frp_tpu_torch.ops.anchors import RETINAFACE_CFG


def encode_boxes(gt: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    """gt [..., A, 4] xyxy (matched per anchor), priors [A, 4] cxcywh
    normalized -> loc targets [..., A, 4] (the inverse of decode_boxes)."""
    v0, v1 = RETINAFACE_CFG["variances"]
    gt_cxy = (gt[..., :2] + gt[..., 2:]) / 2.0
    gt_wh = torch.clamp(gt[..., 2:] - gt[..., :2], min=1e-6)
    t_cxy = (gt_cxy - priors[..., :2]) / (v0 * priors[..., 2:])
    t_wh = torch.log(gt_wh / priors[..., 2:]) / v1
    return torch.cat([t_cxy, t_wh], dim=-1)


def encode_landmarks(gt_ldm: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
    """gt_ldm [..., A, 10] (x1,y1..x5,y5) -> targets [..., A, 10] (the
    inverse of decode_landmarks)."""
    v0, _ = RETINAFACE_CFG["variances"]
    pts = gt_ldm.reshape(*gt_ldm.shape[:-1], 5, 2)
    t = (pts - priors[..., None, :2]) / (v0 * priors[..., None, 2:])
    return t.reshape(*gt_ldm.shape[:-1], 10)


def _iou_anchors_gt(anchors_xyxy: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """[A, 4] x [B, G, 4] -> [B, A, G] IoU."""
    a = anchors_xyxy[None, :, None, :]
    g = gt[:, None, :, :]
    ix1 = torch.maximum(a[..., 0], g[..., 0])
    iy1 = torch.maximum(a[..., 1], g[..., 1])
    ix2 = torch.minimum(a[..., 2], g[..., 2])
    iy2 = torch.minimum(a[..., 3], g[..., 3])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    a_area = torch.clamp(a[..., 2] - a[..., 0], min=0) * torch.clamp(a[..., 3] - a[..., 1], min=0)
    g_area = torch.clamp(g[..., 2] - g[..., 0], min=0) * torch.clamp(g[..., 3] - g[..., 1], min=0)
    return inter / torch.clamp(a_area + g_area - inter, min=1e-12)


def assign_targets(
    priors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_ldm: torch.Tensor,
    gt_valid: torch.Tensor,
    pos_thresh: float = 0.35,
    neg_thresh: float = 0.35,
) -> dict:
    """Per-anchor training targets of a batch.

    Args:
        priors: [A, 4] cxcywh normalized (generate_anchors output).
        gt_boxes: [B, G, 4] xyxy normalized (0..1), zero-padded.
        gt_ldm: [B, G, 10] normalized landmark coords (0..1), zero-padded.
        gt_valid: [B, G] bool.
    Returns dict: labels [B, A] int32 (1 pos / 0 neg / -1 ignore),
        loc_targets [B, A, 4], ldm_targets [B, A, 10],
        ldm_valid [B, A] bool (positives whose GT has usable landmarks).
    """
    b, a, g = gt_boxes.shape[0], priors.shape[0], gt_boxes.shape[1]
    anchors_xyxy = torch.cat([priors[:, :2] - priors[:, 2:] / 2,
                              priors[:, :2] + priors[:, 2:] / 2], dim=1)
    iou = _iou_anchors_gt(anchors_xyxy, gt_boxes)  # [B, A, G]
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))

    # argmax and max return the first of equal maxima, as jnp.argmax
    best_gt_iou, best_gt_idx = iou.max(dim=2)  # [B, A]

    # force-match: each GT's best anchor becomes positive for that GT. Padded
    # GT columns are all -1 IoU, so they all argmax to anchor 0; a scatter
    # that sets would leave anchor 0 to whichever duplicate lands last (on
    # CUDA an undefined order) and could drop a valid GT's only positive.
    # The max-scatter of the JAX package instead: a valid GT always wins and
    # ties go to the highest GT index, whatever the order.
    best_anchor_idx = iou.argmax(dim=1)  # [B, G]
    g_idx = torch.arange(g, device=gt_boxes.device).expand(b, g)
    forced = torch.zeros((b, a), dtype=torch.int32, device=gt_boxes.device).scatter_reduce(
        1, best_anchor_idx, gt_valid.to(torch.int32), "amax") > 0
    forced_gt = torch.full((b, a), -1, dtype=torch.int64, device=gt_boxes.device).scatter_reduce(
        1, best_anchor_idx, torch.where(gt_valid, g_idx, -1), "amax")
    best_gt_idx = torch.where(forced_gt >= 0, forced_gt, best_gt_idx)

    positive = (best_gt_iou >= pos_thresh) | forced
    negative = ~positive & (best_gt_iou < neg_thresh)
    labels = torch.where(positive, 1, torch.where(negative, 0, -1)).to(torch.int32)

    matched_boxes = torch.gather(gt_boxes, 1, best_gt_idx[..., None].expand(b, a, 4))
    matched_ldm = torch.gather(gt_ldm, 1, best_gt_idx[..., None].expand(b, a, 10))
    loc_targets = encode_boxes(matched_boxes, priors)
    ldm_targets = encode_landmarks(matched_ldm, priors)
    # the landmark loss only where the GT landmarks are meaningful
    ldm_ok = (matched_ldm.reshape(b, a, 5, 2).std(dim=2, correction=0) > 1e-6).any(dim=-1)
    return {
        "labels": labels,
        "loc_targets": loc_targets,
        "ldm_targets": ldm_targets,
        "ldm_valid": positive & ldm_ok,
    }


def multibox_loss(
    pred_loc: torch.Tensor,
    pred_ldm: torch.Tensor,
    pred_cls_logits: torch.Tensor,
    targets: dict,
    neg_pos_ratio: float = 7.0,
) -> dict:
    """Per-image RetinaFace loss of a batch, each entry [B]: smooth-L1 loc +
    smooth-L1 landmarks + cross-entropy with hard-negative mining at
    neg:pos 7:1 (the hardest backgrounds, a descending sort summed under a
    float count, as ``frp_tpu/ops/anchor_targets.py:146-154``)."""
    labels = targets["labels"]
    pos = labels == 1

    def smooth_l1(x):
        ax = torch.abs(x)
        return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)

    n_pos = torch.clamp(pos.to(torch.float32).sum(-1), min=1.0)
    loc_loss = (smooth_l1(pred_loc - targets["loc_targets"]).sum(-1) * pos).sum(-1) / n_pos
    ldm_mask = targets["ldm_valid"].to(torch.float32)
    ldm_loss = (smooth_l1(pred_ldm - targets["ldm_targets"]).sum(-1) * ldm_mask).sum(-1) \
        / torch.clamp(ldm_mask.sum(-1), min=1.0)

    ce = -torch.log_softmax(pred_cls_logits, dim=-1)
    pos_ce = torch.where(pos, ce[..., 1], torch.zeros_like(ce[..., 1]))
    neg_ce_all = torch.where(labels == 0, ce[..., 0], torch.full_like(ce[..., 0], -torch.inf))
    k = pred_cls_logits.shape[-2]
    n_neg = torch.minimum(neg_pos_ratio * n_pos, (labels == 0).to(torch.float32).sum(-1))
    # a stable ascending sort, reversed (jnp.sort(x)[::-1]): of equal losses
    # (anchors over a flat background see equal inputs) the later anchors
    # come first, so the count selects, and the gradient reaches, the same
    # anchors as in the JAX step; a descending sort would pick the earlier
    sorted_neg = torch.sort(neg_ce_all, dim=-1, stable=True).values.flip(-1)
    rank = torch.arange(k, dtype=torch.float32, device=pred_cls_logits.device)
    finite = torch.where(torch.isfinite(sorted_neg), sorted_neg, torch.zeros_like(sorted_neg))
    neg_ce = torch.where(rank < n_neg[..., None], finite, torch.zeros_like(finite)).sum(-1)
    cls_loss = (pos_ce.sum(-1) + neg_ce) / n_pos
    return {
        "loss": cls_loss + 2.0 * loc_loss + ldm_loss,
        "cls_loss": cls_loss,
        "loc_loss": loc_loss,
        "ldm_loss": ldm_loss,
        "n_pos": n_pos,
    }
