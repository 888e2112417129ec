"""The BN-activation and BN-add-BN chains of the inference forwards in one
pass each: the CUDA kernel ``csrc/bn_act.cu`` and its plain PyTorch twin.
iresnet's embedder (``models/iresnet.py``) runs its BN-PReLU and BN-add-BN
chains through it, RetinaFace's detector (``models/retinaface.py``) the BN
and leaky ReLU or PReLU after each activated conv.

Replaces no TPU kernel: the JAX package leaves these element-wise chains to
XLA, which fuses them. The port's eager forward ran each op of a chain as a
kernel of its own, and at the embed rung of 1664 faces those kernels were
most of the iresnet50 forward's device time, and about half of the
detector's at 128 frames: a BN is two passes over the activation, a PReLU
or leaky ReLU three, the residual add one, a stride-2 conv's padding a
copy. One pass a chain reads each activation once and writes each output
once.

- ``bn_prelu(x, bn, act)``: y = prelu(bn(x)), with ``bn_next`` also
  u = bn_next(y), with ``pad=(rows, columns)`` y written into a buffer with
  that many zero rows below and columns right (the input of a stride-2 conv
  under XLA SAME padding, ``nn.explicit_pad``).
- ``bn_leaky(x, bn, slope)``: y = leaky_relu(bn(x), slope), with ``pad`` as
  ``bn_prelu``'s. The slope is one Python float, which the kernel takes as
  an f32 scalar, as ``nn.leaky_relu``'s multiply by a Python scalar
  computes it; a tensor of slopes is refused (a bf16 0.1 is 0.10009765625,
  another model).
- ``bn_add(x, bn, shortcut, bn_next)``: r = shortcut + bn(x), the shortcut
  through ``down_bn`` first where given, and u = bn_next(r); with
  ``keep=False`` u alone (after the last block, whose r nothing reads).

x and the shortcut are NCHW views of channels-last memory, as the convs
give them; the scales, shifts and slopes are those ``nn.batch_norm`` and
``nn.prelu`` fold and cast, cached per dtype in the layers' dicts.

Dispatch: CPU tensors take the plain twin, today's chain of ``nn.batch_norm``,
``nn.prelu`` or ``nn.leaky_relu``, ``F.pad`` and ``+``, so the CPU forward is
bit for bit what it was. CUDA tensors launch the kernel or raise: on a dtype
other than f32 or bf16, a tensor that is not channels-last contiguous or not
16-byte aligned, a shortcut of another shape, a parameter of another length
than C, or a C whose 16-byte vectors a pixel do not divide 256. The kernel
computes in f32 and rounds once a store, so in bf16 it agrees with the twin
computed in f32 and rounded once, not with the twin's bf16 roundings between
ops; in f32 it is the twin bit for bit. The library is loaded as a
``ctypes.PyDLL`` (``keep_gil`` in ``KERNEL``): a launch keeps the
interpreter lock, which a release would hand to the engine's producer
thread for about a millisecond, some 49 times an iresnet50 forward.
``KERNEL.launches`` counts kernel launches: one for the stem and two a
block of an iresnet, 1 + 2 x blocks a forward; one an activated conv of the
detector, 38 a forward.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from frp_tpu_torch.models import nn
from frp_tpu_torch.ops import cuda_build

# the kernel's mode bits (csrc/bn_act.cu)
PRELU, ADD_ID, ADD_DOWN, WRITE_R, NEXT, PAD, LEAKY = 1, 2, 4, 8, 16, 32, 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256  # a block's threads (csrc/bn_act.cu kThreads)

KERNEL = cuda_build.Kernel(
    "bn_act", [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11 + [ctypes.c_longlong]
    + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_void_p], keep_gil=True)


def bn_prelu_plain(x: torch.Tensor, bn: dict, act: dict, bn_next: dict | None = None,
                   pad: tuple[int, int] | None = None):
    """prelu(bn(x)), padded with ``pad`` zero rows and columns, or
    (y, bn_next(y)): the eager chain."""
    y = nn.prelu(act, nn.batch_norm(bn, x))
    if pad is not None:
        y = F.pad(y, (0, pad[1], 0, pad[0]))
    return y if bn_next is None else (y, nn.batch_norm(bn_next, y))


def bn_leaky_plain(x: torch.Tensor, bn: dict, slope: float = 0.1,
                   pad: tuple[int, int] | None = None) -> torch.Tensor:
    """leaky_relu(bn(x), slope), padded with ``pad`` zero rows and columns:
    the eager chain."""
    y = nn.leaky_relu(nn.batch_norm(bn, x), slope)
    return y if pad is None else F.pad(y, (0, pad[1], 0, pad[0]))


def bn_add_plain(x: torch.Tensor, bn: dict, shortcut: torch.Tensor, bn_next: dict,
                 down_bn: dict | None = None, keep: bool = True):
    """(r, u): r = shortcut + bn(x), the shortcut through down_bn first where
    given, None when not kept; u = bn_next(r)."""
    if down_bn is not None:
        shortcut = nn.batch_norm(down_bn, shortcut)
    r = shortcut + nn.batch_norm(bn, x)
    return (r if keep else None), nn.batch_norm(bn_next, r)


def _vector(t: torch.Tensor, c: int, like: torch.Tensor, what: str) -> int:
    """The data pointer of a parameter as the kernel reads it: C values of
    x's dtype on x's device (a fold's [C, 1, 1] view too), contiguous and
    16-byte aligned."""
    if (t.numel() != c or t.dtype != like.dtype or t.device != like.device
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"bn_act: {what} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                         f"contiguous {t.is_contiguous()}, at {t.data_ptr() % 16} past 16 "
                         f"bytes; the activation is {like.dtype} with C={c} on {like.device}")
    return t.data_ptr()


def _activation(t: torch.Tensor, what: str) -> None:
    if t.dim() != 4 or t.dtype not in _DTYPES:
        raise ValueError(f"bn_act: {what} must be a 4-D f32 or bf16 tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous(memory_format=torch.channels_last) or t.data_ptr() % 16:
        raise ValueError(f"bn_act: {what} {tuple(t.shape)} is not channels-last contiguous "
                         "and 16-byte aligned")


def operands(x: torch.Tensor, sc: torch.Tensor | None, params: dict,
             pad: tuple[int, int] | None) -> tuple[int, int, int, dict]:
    """Check what one launch would be given, on any device: x and the
    shortcut channels-last f32 or bf16 of one shape, dtype and device,
    each parameter [C] of x's dtype on x's device. Returns (vectors a pixel,
    output height, output width, {name: data pointer})."""
    _activation(x, "x")
    b, c, h, w = x.shape
    lanes = 16 // x.element_size()
    cv = c // lanes
    if c % lanes or cv & (cv - 1) or _THREADS % cv:
        raise ValueError(f"bn_act: C={c} is not a power-of-two multiple of {lanes} up to "
                         f"{_THREADS * lanes}")
    ho, wo = (h, w) if pad is None else (h + pad[0], w + pad[1])
    if b * ho * wo >= 2**31:
        raise ValueError(f"bn_act: {b} x {ho} x {wo} pixels: the kernel counts them in 32 bits")
    if sc is not None:
        _activation(sc, "the shortcut")
        if sc.shape != x.shape or sc.dtype != x.dtype or sc.device != x.device:
            raise ValueError(f"bn_act: shortcut {sc.dtype} {tuple(sc.shape)} on {sc.device} "
                             f"against x {x.dtype} {tuple(x.shape)} on {x.device}")
    return cv, ho, wo, {k: _vector(v, c, x, k) for k, v in params.items()}


def _launch(mode: int, x: torch.Tensor, sc: torch.Tensor | None, params: dict,
            pad: tuple[int, int] | None, outputs: tuple[bool, bool], slope: float = 0.0):
    """Check the operands, allocate the outputs ((r, u), each None where not
    asked), launch once."""
    if not x.is_cuda:
        raise ValueError(f"bn_act: the kernel takes CUDA tensors, not {x.device}")
    cv, ho, wo, ptr = operands(x, sc, params, pad)
    b, c, h, w = x.shape

    def out():
        return torch.empty((b, c, ho, wo), dtype=x.dtype, device=x.device,
                           memory_format=torch.channels_last)

    r = out() if outputs[0] else None
    u = out() if outputs[1] else None
    if x.numel():
        KERNEL(
            _DTYPES[x.dtype], mode, x.data_ptr(), None if sc is None else sc.data_ptr(),
            None if r is None else r.data_ptr(), None if u is None else u.data_ptr(),
            ptr["s"], ptr["t"], ptr.get("a"), ptr.get("sd"), ptr.get("td"), ptr.get("s1"),
            ptr.get("t1"), b * ho * wo * cv, cv, h, w, ho, wo, slope,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    return r, u


def bn_prelu(x: torch.Tensor, bn: dict, act: dict, bn_next: dict | None = None,
             pad: tuple[int, int] | None = None):
    """prelu(bn(x)) (with ``pad``, padded), or (y, bn_next(y)) with
    ``bn_next``: the plain twin for CPU tensors, one kernel launch for CUDA
    tensors."""
    if x.device.type == "cpu":
        return bn_prelu_plain(x, bn, act, bn_next, pad)
    if pad is not None and bn_next is not None:
        raise ValueError("bn_act: a padded output takes no bn_next")
    s, t = nn.bn_fold(bn, x)
    params = {"s": s, "t": t, "a": nn._cast(act, "alpha", x.dtype)}
    mode = PRELU | WRITE_R
    if bn_next is not None:
        params["s1"], params["t1"] = nn.bn_fold(bn_next, x)
        mode |= NEXT
    if pad is not None:
        mode |= PAD
    y, u = _launch(mode, x, None, params, pad, (True, bn_next is not None))
    return y if bn_next is None else (y, u)


def bn_leaky(x: torch.Tensor, bn: dict, slope: float = 0.1,
             pad: tuple[int, int] | None = None) -> torch.Tensor:
    """leaky_relu(bn(x), slope) (with ``pad``, padded): the plain twin for
    CPU tensors, one kernel launch for CUDA tensors. ``slope`` is one Python
    float on either route."""
    if not isinstance(slope, float):
        raise ValueError(f"bn_act: the leaky slope is one Python float, taken in f32 as "
                         f"nn.leaky_relu takes it, not {type(slope).__name__}")
    if x.device.type == "cpu":
        return bn_leaky_plain(x, bn, slope, pad)
    s, t = nn.bn_fold(bn, x)
    y, _ = _launch(LEAKY | WRITE_R | (0 if pad is None else PAD), x, None, {"s": s, "t": t},
                   pad, (True, False), float(slope))
    return y


def bn_add(x: torch.Tensor, bn: dict, shortcut: torch.Tensor, bn_next: dict,
           down_bn: dict | None = None, keep: bool = True):
    """(r, u) of ``bn_add_plain``: the plain twin for CPU tensors, one kernel
    launch for CUDA tensors."""
    if x.device.type == "cpu":
        return bn_add_plain(x, bn, shortcut, bn_next, down_bn, keep)
    s, t = nn.bn_fold(bn, x)
    s1, t1 = nn.bn_fold(bn_next, x)
    params = {"s": s, "t": t, "s1": s1, "t1": t1}
    mode = ADD_ID | NEXT
    if down_bn is not None:
        params["sd"], params["td"] = nn.bn_fold(down_bn, x)
        mode = ADD_DOWN | NEXT
    if keep:
        mode |= WRITE_R
    return _launch(mode, x, shortcut, params, None, (keep, True))
