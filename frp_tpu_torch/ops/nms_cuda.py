"""Greedy NMS suppression: the CUDA kernel ``csrc/greedy_nms.cu`` and its
plain PyTorch version.

Replaces the TPU kernel ``frp_tpu/ops/nms_pallas.py::_suppress_kernel``
(via ``greedy_suppress``): from a [B, K, K] effective-overlap matrix with
rows in rank order and a [B, K] above-threshold mask, the sequential greedy
keep mask. ``ops/nms.py::nms_padded_batched`` runs it: every call of
``build_pipeline``, ``nms_padded``, and the detection stage when
``pre_nms_topk`` > 256.

Bound on the H100: the keep mask depends only on the overlaps above the
diagonal (j > i), read once: 1.04 MB per batch of 8 at K=256, 4.19 MB at
K=512 and 16.8 MB at K=1024 (about 0.31, 1.25 and 5.0 us at 3.35 TB/s). The
kernel reads less than that: only rows of candidates above the score
threshold, and of those only the 32-column words right of the diagonal that
hold a candidate above, because the greedy pass can read nothing else. So a
share of the bound is no efficiency; its time is a launch, two cluster
barriers, one round trip to memory and the walk's chain of dependent steps.
Design: a thread-block cluster of 8 blocks per frame (64 SMs for a batch of
8; the card runs only 7 clusters of 16 at once, which measured slower). The
rows are dealt to the cluster's 128 warps, a warp a row, two rows in flight,
16 bytes a lane a load; each warp thresholds its row into bitmask words and
writes them into block 0's shared memory through distributed shared memory,
column-major with an odd stride so that neither the stores nor the walk's
loads meet a bank conflict. Block 0 then walks the ranks a word of 32 at a
time in one warp: the suppressed bits of a word are one column of the mask
gathered over the kept earlier ranks and joined by one warp-wide OR, and the
kept set within the word is a fixed point found by ballots, from transposed
diagonal blocks that all warps prepare before the walk. K <= 1024 (128 KB
mask). The wrapper hands the kernel the bool tensors' bytes as they are: a
conversion to uint8 and back would be two more launches.

Measured on an NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py``, B=8, median
of 50 launches): 10.5 us at K=256, 15.2 us at K=512 and 27.0 us at K=1024
with 60 % of the candidates above; at K=512 15.1 us with all above in a
crowd and 13.4 us with 10 % above; a one-element add timed the same way
takes 5.1 us. The one-block kernel it replaces took 24.2, 71.0 and 249.2 us
at K=256, 512 and 1024 in one run with it (``testing/kernel_ab.py``).

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel or raise. ``KERNEL.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from frp_tpu_torch.ops import cuda_build

MAX_K = 1024

KERNEL = cuda_build.Kernel(
    "greedy_nms",
    [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    replaces="frp_tpu/ops/nms_pallas.py:26")


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
    if not eff.is_cuda or eff.dtype != torch.float32 or eff.dim() != 3:
        raise ValueError("greedy_suppress_kernel needs a CUDA f32 [B, K, K] overlap")
    b, k, k2 = eff.shape
    if k != k2 or tuple(above.shape) != (b, k) or above.device != eff.device:
        raise ValueError(f"shape mismatch: overlap {tuple(eff.shape)}, above {tuple(above.shape)}")
    if k > MAX_K:
        raise ValueError(f"K={k} exceeds the kernel's K <= {MAX_K}")
    eff = eff.contiguous()
    # a bool tensor is one byte of 0 or 1 an element, which is what the kernel
    # reads and writes: no conversion kernel before or after it
    above = (above if above.dtype == torch.bool else above != 0).contiguous()
    keep = torch.empty((b, k), dtype=torch.bool, device=eff.device)
    KERNEL(
        eff.data_ptr(), above.data_ptr(), keep.data_ptr(), b, k,
        float(thresh), torch.cuda.current_stream(eff.device).cuda_stream,
    )
    return keep


def greedy_suppress(
    eff: torch.Tensor, above: torch.Tensor, thresh: float = 1.0
) -> torch.Tensor:
    """Greedy keep mask [B, K] bool: the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    if eff.device.type == "cpu":
        return greedy_suppress_plain(eff, above, thresh)
    return greedy_suppress_kernel(eff, above, thresh)
