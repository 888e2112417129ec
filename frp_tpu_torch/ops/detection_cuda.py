"""Fused RetinaFace detection head: the CUDA kernel
``csrc/detection_head.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``frp_tpu/ops/detection_pallas.py::_fused_head_kernel``
(via ``fused_detection_head``): per frame, anchor and landmark decode of the
top-K candidates, effective overlap max(IoU/iou_t, IoM/iom_t), greedy
suppression in rank order, and rank-order compaction of the kept boxes into
M slots. The top-K over all anchors stays outside the kernel, as in JAX.

Candidate payload [B, K, 19] f32: 0:4 loc deltas, 4:14 landmark deltas,
14:18 prior (cx, cy, w, h), 18 score. Output [B, M, 16] f32: 0:4 box xyxy
px, 4:14 landmarks px, 14 score, 15 valid flag.

Bound on the H100: the kernel moves about 164 KB per batch of 8 at K=256,
M=16, well under a microsecond of memory time; what it costs is the pair
tests and the greedy pass, whose steps depend on each other. Design: a
thread-block cluster of 8 blocks per frame (64 SMs for a batch of 8). Every
block copies the frame's payload into shared memory and decodes the boxes;
the rows of the K x K overlap bitmask (8 KB at K=256, where a f32 matrix
would not fit a block's shared memory) are dealt to the cluster's warps, one
warp ballot per 32-candidate word, and written into block 0 through
distributed shared memory. Only pairs whose two candidates are both above
the score threshold are tested: the greedy pass reads no other bit. Block 0
runs the greedy pass in one warp (``csrc/greedy.cuh``), a word of 32 ranks
at a time, and a prefix popcount places the kept ranks. K <= 256; larger K
routes to decode + ``ops/nms.py::nms_padded_batched`` (the greedy kernel of
``nms_cuda``). The kernel fills the slots in row order, which is the plain
version's order (by score, ties by row) when the payload is sorted by score,
as ``build_payload`` makes it. Measured on an NVIDIA H100 80GB HBM3 at
700 W (``chip_smoke.py``, B=8, K=256, M=16): 11.2 us with 64 candidates a
frame above the threshold, 15.0 us with all 256 above in a crowd; a
one-element add timed the same way takes 5.2 us.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel or raise. ``KERNEL.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from frp_tpu_torch.ops import cuda_build
from frp_tpu_torch.ops.decode import decode_boxes, decode_landmarks
from frp_tpu_torch.ops.nms import _select_slots, nms_padded_batched, overlap_matrix
from frp_tpu_torch.ops.nms_cuda import greedy_suppress_plain
from frp_tpu_torch.ops.topk import top_k

PAYLOAD = 19
OUT_COLS = 16
MAX_K = 256

KERNEL = cuda_build.Kernel(
    "detection_head",
    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_float] * 4 + [ctypes.c_void_p],
    replaces="frp_tpu/ops/detection_pallas.py:41")


def build_payload(loc, ldm, scores, priors, k: int) -> torch.Tensor:
    """The [B, K, 19] f32 candidate payload of the top-k anchors by score
    (stable: lower anchor index first on ties, as ``lax.top_k``)."""
    top_scores, top_idx = top_k(scores, k)  # [B, K] descending

    def gather(x):
        return torch.gather(x, 1, top_idx[..., None].expand(-1, -1, x.shape[-1]))

    return torch.cat(
        [gather(loc), gather(ldm), priors[top_idx], top_scores[..., None]], dim=-1,
    ).to(torch.float32).contiguous()


def fused_head_plain(
    payload: torch.Tensor, max_out: int, conf_thresh: float, iou_thresh: float,
    iom_thresh: float, image_size: float,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: payload [B, K, 19] -> [B, M, 16]
    by decode, ``overlap_matrix``, the plain greedy pass and the slot
    selection of ``ops/nms.py``."""
    k = payload.shape[1]
    priors = payload[..., 14:18]
    boxes = decode_boxes(payload[..., 0:4], priors, image_size)
    ldm = decode_landmarks(payload[..., 4:14], priors, image_size)
    score = payload[..., 18]
    eff = overlap_matrix(boxes, iou_thresh, iom_thresh)
    keep = greedy_suppress_plain(eff, score >= conf_thresh, 1.0)
    sel = _select_slots(keep, score, boxes, ldm, max_out, k)
    return torch.cat(
        [sel["boxes"], sel["landmarks"], sel["scores"][..., None],
         sel["valid"].to(torch.float32)[..., None]], dim=-1,
    )


def fused_head_kernel(
    payload: torch.Tensor, max_out: int, conf_thresh: float, iou_thresh: float,
    iom_thresh: float, image_size: float,
) -> torch.Tensor:
    """Launch ``csrc/detection_head.cu``; same result as ``fused_head_plain``."""
    if not payload.is_cuda or payload.dtype != torch.float32 or payload.dim() != 3:
        raise ValueError("fused_head_kernel needs a CUDA f32 [B, K, 19] payload")
    b, k, cols = payload.shape
    if cols != PAYLOAD or not 0 < k <= MAX_K or not 0 < max_out <= k:
        raise ValueError(
            f"payload {tuple(payload.shape)} with M={max_out}: the kernel "
            f"takes [B, K<={MAX_K}, {PAYLOAD}] and M <= K")
    payload = payload.contiguous()
    out = torch.empty((b, max_out, OUT_COLS), dtype=torch.float32, device=payload.device)
    KERNEL(
        payload.data_ptr(), out.data_ptr(), b, k, max_out, float(conf_thresh),
        float(iou_thresh), float(iom_thresh), float(image_size),
        torch.cuda.current_stream(payload.device).cuda_stream,
    )
    return out


def fused_head(payload, max_out, conf_thresh, iou_thresh, iom_thresh, image_size):
    """[B, K, 19] -> [B, M, 16]: the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    fn = fused_head_plain if payload.device.type == "cpu" else fused_head_kernel
    return fn(payload, max_out, conf_thresh, iou_thresh, iom_thresh, image_size)


def fused_detection_head(
    loc: torch.Tensor,
    ldm: torch.Tensor,
    scores: torch.Tensor,
    priors: torch.Tensor,
    *,
    pre_topk: int = 256,
    max_out: int = 16,
    conf_thresh: float = 0.5,
    iou_thresh: float = 0.4,
    iom_thresh: float = 0.5,
    image_size: float = 640.0,
):
    """RetinaFace head post-processing: raw (loc [B, A, 4], ldm [B, A, 10],
    scores [B, A], priors [A, 4]) -> padded detection slots: boxes [B, M, 4]
    px, landmarks [B, M, 10] px, scores [B, M], valid [B, M] bool, count [B]
    int32. Same semantics as decode + ``nms_padded_batched``."""
    b, a = scores.shape
    k = min(pre_topk, a)
    if k > MAX_K:
        return nms_padded_batched(
            decode_boxes(loc, priors, image_size),
            scores,
            decode_landmarks(ldm, priors, image_size),
            pre_topk=pre_topk,
            max_out=max_out,
            conf_thresh=conf_thresh,
            iou_thresh=iou_thresh,
            iom_thresh=iom_thresh,
        )
    if max_out > k:
        raise ValueError(f"max_out={max_out} > pre_topk candidates {k}")
    payload = build_payload(loc, ldm, scores, priors, k)
    out = fused_head(payload, max_out, conf_thresh, iou_thresh, iom_thresh, image_size)
    valid = out[..., 15] > 0.5
    zero = out.new_zeros(())
    return {
        "boxes": torch.where(valid[..., None], out[..., 0:4], zero),
        "landmarks": torch.where(valid[..., None], out[..., 4:14], zero),
        "scores": torch.where(valid, out[..., 14], zero),
        "valid": valid,
        "count": valid.sum(dim=-1, dtype=torch.int32),
    }
