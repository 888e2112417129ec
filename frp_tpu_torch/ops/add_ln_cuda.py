"""The ViT embedder's residual adds, each with the LayerNorm after it, in one
pass: the CUDA kernel ``csrc/add_ln.cu`` and its plain PyTorch twin.

Replaces no TPU kernel: the JAX package leaves these element-wise ops to
XLA, which fuses them. The port's eager forward ran the add and the
LayerNorm as a kernel each over the whole residual stream (and the final
LN a cast to float32 before it and one back after it); one pass reads x
and d once and writes r and LN(r) once.

- ``add_ln(x, d, ln, eps)``: (r, LN(r)) with r = x + d, the LN's gamma and
  beta ``ln["gamma"]`` and ``ln["beta"]`` cast to x's dtype. d is x's shape
  or x's trailing axes, added to every leading index (the pos_embed
  [T, W] over the batch).
- ``add_ln(x, d, ln, eps, last=True)``: (None, LN(r)), the LN taken in
  float32 from r as stored, with float32 gamma and beta, and rounded once
  to x's dtype: the ViT's final LN, whose r nothing reads.

Dispatch: CPU tensors take the plain twin, today's ``x + d`` and
``nn.layer_norm`` (at the last site ``.to(float32)``, the float32
``nn.layer_norm`` and the cast back), so the CPU forward is bit for bit
what it was. CUDA tensors launch the kernel or raise: on a dtype other than
f32 or bf16, a tensor that is not contiguous or not 16-byte aligned, a d
whose shape is neither x's nor x's trailing axes, a width that is not a
whole number of 16-byte vectors or above ``MAX_WIDTH``, or an input that
would record a gradient (the kernel has no backward). The kernel computes in
f32 and rounds once a store, with the statistics from r as rounded; only
the order of the sums inside the mean and variance (and a correctly rounded
1 / sqrt for PyTorch's rsqrtf) differs from eager's. ``add_ln_f32`` is the
twin's arithmetic in f32 in the kernel's order, rounded once: the plain
version the kernel is held to on the card, bit for bit before the rounding.
The library is loaded as a ``ctypes.PyDLL`` (``keep_gil`` in ``KERNEL``), as
``bn_act``'s: a launch keeps the interpreter lock. ``KERNEL.launches``
counts kernel launches: 2 x depth + 1 a ViT forward.
"""

from __future__ import annotations

import ctypes

import torch

from frp_tpu_torch.models import nn
from frp_tpu_torch.ops import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_WIDTH = 1024  # 32 elements a lane of the row's warp (csrc/add_ln.cu kMaxElems)

KERNEL = cuda_build.Kernel(
    "add_ln", [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
    + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p], keep_gil=True)


def add_ln_plain(x: torch.Tensor, d: torch.Tensor, ln: dict, eps: float, last: bool = False):
    """(r, LN(r)) with r = x + d; with ``last``, (None, the float32 LN of r
    cast back to x's dtype): the eager ops."""
    r = x + d
    if last:
        return None, nn.layer_norm(ln, r.to(torch.float32), eps).to(x.dtype)
    return r, nn.layer_norm(ln, r, eps)


def add_ln_f32(x: torch.Tensor, d: torch.Tensor, ln: dict, eps: float, last: bool = False):
    """``add_ln``'s (r, LN(r)) computed as the kernel computes it, in f32 and
    rounded once to x's dtype: r = x + d rounded; each row's sums taken as a
    warp takes them (lane l holds the 16-byte vectors l, l + 32, ... of the
    row and sums its elements in order; then a butterfly over the lanes,
    xor 16 to 1); mean = sum / W, var = the squares about the mean / W,
    rstd = 1 / sqrt(var + eps); LN = (r - mean) * rstd * gamma + beta, each
    operation rounded to f32, with gamma and beta as the kernel reads them
    (x's dtype, f32 at the last site)."""
    w = x.shape[-1]
    lanes = 16 // x.element_size()
    per = -(-w // (32 * lanes)) * 32 * lanes  # the row padded to whole warps' vectors
    r = (x.float() + d.float()).to(x.dtype)
    v = r.float().reshape(-1, w)
    full = torch.zeros((v.shape[0], per), dtype=torch.float32, device=x.device)
    full[:, :w] = v
    # [rows, vectors a lane, lane, element]
    full = full.view(v.shape[0], per // (32 * lanes), 32, lanes)
    lane = torch.arange(32, device=x.device)
    width = torch.tensor(float(w), device=x.device)

    def row_sum(t):
        s = torch.zeros((t.shape[0], 32), dtype=torch.float32, device=x.device)
        for j in range(t.shape[1]):
            for k in range(lanes):
                s = s + t[:, j, :, k]
        for o in (16, 8, 4, 2, 1):
            s = s + s[:, lane ^ o]
        return s[:, :1]

    mean = row_sum(full) / width
    t = full.view(v.shape[0], per) - mean
    sq = t * t
    sq[:, w:] = 0.0
    var = row_sum(sq.view(full.shape)) / width
    rstd = torch.reciprocal(torch.sqrt(var + eps))
    dtype = torch.float32 if last else x.dtype
    g, b = (nn._cast(ln, k, dtype).float() for k in ("gamma", "beta"))
    out = (((v - mean) * rstd) * g + b).to(x.dtype).view(x.shape)
    return (None if last else r), out


def _tensor(t: torch.Tensor, what: str) -> None:
    if t.dtype not in _DTYPES:
        raise ValueError(f"add_ln: {what} must be f32 or bf16, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"add_ln: {what} {tuple(t.shape)} is not contiguous and 16-byte aligned")


def operands(x: torch.Tensor, d: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> int:
    """Check what one launch would be given, on any device: x and d
    contiguous f32 or bf16 of one dtype and device, d of x's shape or of
    x's trailing axes, gamma and beta [W] of x's dtype or f32, W a whole
    number of 16-byte vectors up to ``MAX_WIDTH``, nothing that records a
    gradient. Returns d's rows."""
    _tensor(x, "x")
    _tensor(d, "d")
    if x.dim() < 1 or d.dim() < 1 or d.shape != x.shape[x.dim() - d.dim():]:
        raise ValueError(f"add_ln: d {tuple(d.shape)} is neither x's shape {tuple(x.shape)} "
                         "nor its trailing axes")
    if d.dtype != x.dtype or d.device != x.device:
        raise ValueError(f"add_ln: d is {d.dtype} on {d.device}, x {x.dtype} on {x.device}")
    w = x.shape[-1]
    lanes = 16 // x.element_size()
    if w % lanes or w > MAX_WIDTH:
        raise ValueError(f"add_ln: width {w} is not a multiple of {lanes} up to {MAX_WIDTH}")
    for t, what in ((gamma, "gamma"), (beta, "beta")):
        _tensor(t, what)
        if t.shape != (w,) or t.dtype not in (x.dtype, torch.float32) or t.device != x.device:
            raise ValueError(f"add_ln: {what} is {t.dtype} {tuple(t.shape)} on {t.device}; x is "
                             f"{x.dtype} of width {w} on {x.device}")
    if gamma.dtype != beta.dtype:
        raise ValueError(f"add_ln: gamma is {gamma.dtype}, beta {beta.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, d, gamma, beta)):
        raise ValueError("add_ln: the kernel has no backward; run it without grad")
    return d.numel() // w if w else 0


def add_ln(x: torch.Tensor, d: torch.Tensor, ln: dict, eps: float, last: bool = False):
    """``add_ln_plain``'s (r, LN(r)): the plain twin for CPU tensors, one
    kernel launch for CUDA tensors."""
    if x.device.type == "cpu":
        return add_ln_plain(x, d, ln, eps, last)
    if not x.is_cuda:
        raise ValueError(f"add_ln: the kernel takes CUDA tensors, not {x.device}")
    dtype = torch.float32 if last else x.dtype
    gamma, beta = nn._cast(ln, "gamma", dtype), nn._cast(ln, "beta", dtype)
    d_rows = operands(x, d, gamma, beta)
    r = None if last else torch.empty_like(x)
    out = torch.empty_like(x)
    if x.numel():
        KERNEL(
            _DTYPES[x.dtype], _DTYPES[gamma.dtype], x.data_ptr(), d.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), None if r is None else r.data_ptr(), out.data_ptr(),
            x.numel() // x.shape[-1], d_rows, x.shape[-1], eps,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    return r, out
