"""``lax.top_k`` semantics in PyTorch.

``lax.top_k`` returns the k largest values along the last axis in
descending order and, among equal values, the lower index first. Slot
assignment (``ops/nms.py``, ``ops/detection_cuda.py``) and ``best_idx``
(``ops/matching.py``) depend on that order, and ``torch.topk`` on CUDA does
not promise it, so the port takes the first k of a stable descending sort.
"""

from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries along the last axis,
    descending, lower index first among ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
