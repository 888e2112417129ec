"""Greedy NMS suppression: the CUDA kernel ``csrc/greedy_nms.cu`` and its
plain PyTorch version.

Replaces the TPU kernel ``frp_tpu/ops/nms_pallas.py::_suppress_kernel``
(via ``greedy_suppress``): from a [B, K, K] effective-overlap matrix with
rows in rank order and a [B, K] above-threshold mask, the sequential greedy
keep mask. ``ops/nms.py::nms_padded_batched`` runs it; the detection stage
reaches it when ``pre_nms_topk`` > 256.

Bound on the H100: the keep mask depends only on the overlaps above the
diagonal (j > i), which the kernel reads once: 1.04 MB per batch of 8 at
K=256 and 4.19 MB at K=512 (about 0.31 us and 1.25 us at 3.35 TB/s); what
holds it back is that one block per frame reads on 8 of the 132 SMs (the
read takes most of its time, the sequential walk over the ranks the rest).
Design: one block per frame thresholds the overlap into a K x K bitmask
in shared memory with warp ballots (one 128-byte row segment per ballot,
eight segments in flight per warp, nothing read at or below the diagonal),
then one warp runs the greedy walk shared with the detection head
(``csrc/greedy.cuh``). K <= 1024 (128 KB mask).

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel or raise. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from frp_tpu_torch.ops import cuda_build

MAX_K = 1024
LAUNCHES = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = cuda_build.load("greedy_nms").frp_greedy_nms
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def greedy_suppress_plain(
    eff: torch.Tensor, above: torch.Tensor, thresh: float = 1.0
) -> torch.Tensor:
    """The greedy pass as a K-step loop (``frp_tpu/ops/nms.py:189-200``):
    rank i, when above and not suppressed, suppresses every lower rank j > i
    with eff[i, j] > thresh. Returns the [B, K] bool keep mask."""
    b, k, _ = eff.shape
    rng = torch.arange(k, device=eff.device)
    hits = eff > thresh
    above = above.to(torch.bool)
    suppressed = torch.zeros((b, k), dtype=torch.bool, device=eff.device)
    for i in range(k):
        alive = above[:, i] & ~suppressed[:, i]
        suppressed = suppressed | (alive[:, None] & hits[:, i] & (rng > i))
    return above & ~suppressed


def greedy_suppress_kernel(
    eff: torch.Tensor, above: torch.Tensor, thresh: float = 1.0
) -> torch.Tensor:
    """Launch ``csrc/greedy_nms.cu`` on CUDA tensors; same result as
    ``greedy_suppress_plain``."""
    global LAUNCHES
    if not eff.is_cuda or eff.dtype != torch.float32 or eff.dim() != 3:
        raise ValueError("greedy_suppress_kernel needs a CUDA f32 [B, K, K] overlap")
    b, k, k2 = eff.shape
    if k != k2 or tuple(above.shape) != (b, k) or above.device != eff.device:
        raise ValueError(f"shape mismatch: overlap {tuple(eff.shape)}, above {tuple(above.shape)}")
    if k > MAX_K:
        raise ValueError(f"K={k} exceeds the kernel's K <= {MAX_K}")
    eff = eff.contiguous()
    above_u8 = above.to(torch.uint8).contiguous()
    keep = torch.empty((b, k), dtype=torch.uint8, device=eff.device)
    err = _kernel()(
        eff.data_ptr(), above_u8.data_ptr(), keep.data_ptr(), b, k,
        float(thresh), torch.cuda.current_stream(eff.device).cuda_stream,
    )
    cuda_build.check(err, "greedy_nms")
    LAUNCHES += 1
    return keep.to(torch.bool)


def greedy_suppress(
    eff: torch.Tensor, above: torch.Tensor, thresh: float = 1.0
) -> torch.Tensor:
    """Greedy keep mask [B, K] bool: the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    if eff.device.type == "cpu":
        return greedy_suppress_plain(eff, above, thresh)
    return greedy_suppress_kernel(eff, above, thresh)
