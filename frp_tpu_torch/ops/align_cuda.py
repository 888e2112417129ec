"""Exact bilinear crop warp: the CUDA kernel ``csrc/warp_crops.cu`` and its
plain PyTorch version.

Replaces the TPU kernel ``frp_tpu/ops/align_pallas.py::_warp_kernel`` (via
``warp_crops_batched_pallas`` and ``warp_crops_auto``), and computes the
exact semantics of ``frp_tpu/ops/align.py::warp_crops_batched``: for each
(frame, face) an S x S x 3 crop sampled through the inverse similarity at
output pixel centres (+0.5), with the sample coordinate clamped to
[0, w-1] in float space before floor, x0 = min(floor, w-2), and bilinear
weights taken against the clamped index. The TPU kernel's 384-px window,
two-pass shear and B=1 routing are workarounds for its gather limits and
are not carried over: one kernel serves every B.

Bound on the H100: at B=8, M=16, S=112 on 640x640 frames the kernel writes
19.3 MB of f32 crops and reads at most 9.8 MB of uint8 frames, about 8.7 us
at 3.35 TB/s. Design: one thread per output pixel of one face gathers its
4 taps straight from the uint8 frames (no f32 copy of the frame batch) and
writes its 3 channels; coordinates use non-contracted arithmetic so floor()
ties land where the plain version puts them.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel or raise. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from frp_tpu_torch.ops import cuda_build

LAUNCHES = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = cuda_build.load("warp_crops").frp_warp_crops
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def warp_crops_plain(frames: torch.Tensor, inv: torch.Tensor, out_size: int = 112) -> torch.Tensor:
    """frames [B, H, W, C] (uint8 or float), inverse similarities [B, M, 2, 3]
    (output px -> source px) -> [B, M, S, S, C] f32 bilinear crops."""
    b, h, w, c = frames.shape
    m = inv.shape[1]
    s = out_size
    grid = torch.arange(s, dtype=torch.float32, device=frames.device) + 0.5
    gy, gx = torch.meshgrid(grid, grid, indexing="ij")  # [S, S]
    mi = inv.to(torch.float32)[..., None, None]  # [B, M, 2, 3, 1, 1]
    sx = mi[:, :, 0, 0] * gx + mi[:, :, 0, 1] * gy + mi[:, :, 0, 2]  # [B, M, S, S]
    sy = mi[:, :, 1, 0] * gx + mi[:, :, 1, 1] * gy + mi[:, :, 1, 2]
    xs = torch.clamp(sx - 0.5, 0.0, float(w - 1))
    ys = torch.clamp(sy - 0.5, 0.0, float(h - 1))
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), max=w - 2)
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), max=h - 2)
    wx = (xs - x0.to(torch.float32))[..., None]
    wy = (ys - y0.to(torch.float32))[..., None]
    x1 = x0 + 1
    y1 = y0 + 1
    flat = frames.reshape(b, h * w, c).to(torch.float32)

    def gather(yi, xi):
        idx = (yi * w + xi).reshape(b, m * s * s, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(b, m, s, s, c)

    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def warp_crops_kernel(frames: torch.Tensor, inv: torch.Tensor, out_size: int = 112) -> torch.Tensor:
    """Launch ``csrc/warp_crops.cu`` on CUDA uint8 frames [B, H, W, 3]; same
    result as ``warp_crops_plain``."""
    global LAUNCHES
    if not frames.is_cuda or frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError("warp_crops_kernel needs CUDA uint8 frames [B, H, W, 3]")
    b, h, w, _ = frames.shape
    if inv.dim() != 4 or inv.shape[0] != b or tuple(inv.shape[2:]) != (2, 3) or inv.device != frames.device:
        raise ValueError(f"inverse matrices {tuple(inv.shape)} do not fit frames {tuple(frames.shape)}")
    if h < 2 or w < 2:
        raise ValueError(f"frames {h}x{w} are too small to sample")
    m = inv.shape[1]
    frames = frames.contiguous()
    inv = inv.to(torch.float32).contiguous()
    out = torch.empty((b, m, out_size, out_size, 3), dtype=torch.float32, device=frames.device)
    err = _kernel()(
        frames.data_ptr(), inv.data_ptr(), out.data_ptr(), b, h, w, m, out_size,
        torch.cuda.current_stream(frames.device).cuda_stream,
    )
    cuda_build.check(err, "warp_crops")
    LAUNCHES += 1
    return out


def warp_crops(frames: torch.Tensor, inv: torch.Tensor, out_size: int = 112) -> torch.Tensor:
    """[B, M, S, S, 3] f32 crops: the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    if frames.device.type == "cpu":
        return warp_crops_plain(frames, inv, out_size)
    return warp_crops_kernel(frames, inv, out_size)
