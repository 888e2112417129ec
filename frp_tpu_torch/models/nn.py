"""Minimal NN substrate: plain functions on tensors over a parameter dict
(port of ``frp_tpu/models/nn.py``).

Conventions:
  * Init helpers build the JAX package's numpy parameter tree (HWIO conv
    weights, [in, out] dense weights), drawing from the same numpy generator
    in the same order, so a seeded init equals the JAX package's.
    ``models/params.py::convert_params`` turns that tree into the port's
    tensors: OIHW conv weights, [out, in] dense weights, BN stats as they are.
  * Activations inside the models are NCHW views (``permute`` of the NHWC
    input, so cuDNN sees channels-last memory); public model functions take
    NHWC like the JAX package.
  * Weights are f32 masters cast to the activation dtype at use; the cast
    and the folded BN scale/shift are cached per dtype inside the layer's
    parameter dict (keys ``_cast`` and ``_folded``), so a forward launches no
    per-layer parameter arithmetic after the first call. A tensor that
    requires grad (a weight being trained) is cast and folded anew on every
    call, so the result follows the optimizer's in-place updates and the
    gradient reaches the master.
  * BatchNorm is inference-mode by default (scale and shift folded from the
    running stats); ``train=True`` normalises with the batch's statistics and
    returns the updated running stats beside the output, as the JAX
    package's training step expects.
  * Conv padding follows XLA ``SAME`` (a stride-2 conv on an even input pads
    (0, 1)), through an explicit ``F.pad`` where the two sides differ, unless
    the global mode is "torch" (``set_padding_mode``, ``CONV_PADDING``): then
    every "SAME" conv pads k//2 on both sides, as ``torch.nn.Conv2d(padding=
    k//2)`` does, which imported torch/ONNX checkpoints were trained under.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from frp_tpu_torch.parallel.collectives import reduce_sum

# ---------------------------------------------------------------------------
# init helpers: numpy, identical draws to frp_tpu/models/nn.py
# ---------------------------------------------------------------------------


def as_rng(rng_or_seed) -> np.random.Generator:
    if isinstance(rng_or_seed, np.random.Generator):
        return rng_or_seed
    return np.random.default_rng(rng_or_seed)


def conv_init(rng, kh, kw, cin, cout, groups: int = 1) -> dict:
    rng = as_rng(rng)
    fan_in = kh * kw * (cin // groups)
    std = math.sqrt(2.0 / fan_in)
    w = rng.normal(0.0, std, size=(kh, kw, cin // groups, cout)).astype(np.float32)
    return {"w": w}


def bn_init(c: int) -> dict:
    return {
        "gamma": np.ones((c,), np.float32),
        "beta": np.zeros((c,), np.float32),
        "mean": np.zeros((c,), np.float32),
        "var": np.ones((c,), np.float32),
    }


def prelu_init(c: int) -> dict:
    return {"alpha": np.full((c,), 0.25, np.float32)}


def dense_init(rng, cin, cout) -> dict:
    rng = as_rng(rng)
    std = math.sqrt(2.0 / cin)
    return {
        "w": rng.normal(0.0, std, size=(cin, cout)).astype(np.float32),
        "b": np.zeros((cout,), np.float32),
    }


def make_divisible(v: int, divisor: int = 8) -> int:
    """torchvision _make_divisible: round to the nearest multiple, never
    dropping below 90% of the original value."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def conv_bn_init(rng, kh, kw, cin, cout, groups: int = 1) -> dict:
    return {"conv": conv_init(rng, kh, kw, cin, cout, groups), "bn": bn_init(cout)}


def se_init(rng, c: int, reduction: int = 4) -> dict:
    hidden = make_divisible(c // reduction, 8)
    return {"fc1": dense_init(rng, c, hidden), "fc2": dense_init(rng, hidden, c)}


# ---------------------------------------------------------------------------
# apply helpers (x is NCHW)
# ---------------------------------------------------------------------------


def _cast(p: dict, name: str, dtype: torch.dtype) -> torch.Tensor:
    t = p[name]
    if t.dtype == dtype:
        return t
    if t.requires_grad:
        return t.to(dtype)
    cache = p.setdefault("_cast", {})
    got = cache.get((name, dtype))
    if got is None:
        got = cache[(name, dtype)] = t.to(dtype)
    return got


def _leaves(tree):
    """The tensors of a parameter tree, leaving out the layers' caches
    (``_cast``, ``_folded``)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            if not k.startswith("_"):
                yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def records_grad(params: dict, x: torch.Tensor) -> bool:
    """Whether autograd would record a forward of x through params: grad mode
    on, and the input or a parameter requires grad. Where it would not, the
    forwards take their one-pass chains (``ops/bn_act_cuda.py``), which have
    no backward."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in _leaves(params)))


# "same" (XLA asymmetric) | "torch" (symmetric k//2): see set_padding_mode
_PADDING_MODE = os.getenv("CONV_PADDING", "same")


def set_padding_mode(mode: str) -> None:
    """Global conv padding semantics (``frp_tpu/models/nn.py:75-85``).

    "same": XLA SAME, which pads stride-2 even inputs (0, 1), the convention
    the in-repo weights were trained under. "torch": k//2 on both sides, as
    torch's ``Conv2d(padding=k//2)``; imported torch/ONNX checkpoints need it,
    or their stride-2 layers compute on a grid one pixel off the one they were
    trained on. The JAX package reads the mode when it traces a function; the
    port's forwards are eager and read it at every call."""
    if mode not in ("same", "torch"):
        raise ValueError(f"conv padding mode {mode!r}: 'same' or 'torch'")
    global _PADDING_MODE
    _PADDING_MODE = mode


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA SAME padding (lo, hi) of one spatial axis."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def explicit_pad(p: dict, hw, stride: int = 1) -> tuple[int, int] | None:
    """(rows, columns) of zeros that ``conv(p, x, stride)`` appends below and
    right of an input of spatial size hw with ``F.pad`` before it convolves
    (XLA SAME with pads (0, hi) that differ, as a stride-2 conv on an even
    input has): a producer that writes them itself hands conv the padded
    input with padding="VALID". None where conv pads otherwise: symmetric
    pads, a pad before the input, or the "torch" mode."""
    if _PADDING_MODE == "torch":
        return None
    ph = _same_pads(hw[0], p["w"].shape[2], stride)
    pw = _same_pads(hw[1], p["w"].shape[3], stride)
    if (ph[0] == ph[1] and pw[0] == pw[1]) or ph[0] or pw[0]:
        return None
    return ph[1], pw[1]


def conv(p: dict, x: torch.Tensor, stride: int = 1, padding: str = "SAME", groups: int = 1) -> torch.Tensor:
    """Conv with OIHW weights p["w"]; padding "SAME" (XLA, or k//2 on both
    sides in the "torch" mode) or "VALID"."""
    w = _cast(p, "w", x.dtype)
    pad = (0, 0)
    if padding == "SAME" and _PADDING_MODE == "torch":
        pad = (w.shape[2] // 2, w.shape[3] // 2)
    elif padding == "SAME":
        ph = _same_pads(x.shape[2], w.shape[2], stride)
        pw = _same_pads(x.shape[3], w.shape[3], stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    out = F.conv2d(x, w, None, stride, pad, 1, groups)
    if "b" in p:
        out = out + _cast(p, "b", out.dtype)[:, None, None]
    return out


def batch_norm(p: dict, x: torch.Tensor, train: bool = False, momentum: float = 0.9,
               eps: float = 1e-5, group=None):
    """BN over x's channel axis: [B, C, H, W] (NCHW) or [B, C] (a feature BN,
    as iresnet's ``feat_bn``).

    Inference (the default): scale and shift are folded from the running
    stats in f32, then cast to x.dtype (as ``frp_tpu/models/nn.py:121-124``),
    and shaped [C, 1, 1] or [C] for the input's rank: a [C, 1, 1] fold against
    a [B, C] input would broadcast to [C, B, C] without an error.

    ``train=True`` returns (y, {"mean", "var"}) as ``frp_tpu/models/nn.py:
    125-134``: y is normalised with the batch's mean and biased variance in
    f32 and cast to x.dtype; the new running stats are ``momentum * old +
    (1 - momentum) * batch``, in f32, with the biased variance.
    ``F.batch_norm``'s own running update would take the unbiased variance
    and weigh the old value by 1 - momentum, so it is given no running
    stats and they are computed here, outside the graph (the JAX step reads
    them as an auxiliary output, which its gradient does not reach).

    ``group`` (a data process group, with ``train=True``): the statistics of
    the global batch, every rank holding as many rows, as the JAX package's
    global program takes them: the f32 sum over the group, then the sum of
    squared deviations from the global mean over the group, each through an
    all-reduce whose backward sums every rank's gradient."""
    if x.dim() not in (2, 4):
        raise ValueError(f"batch_norm takes [B, C] or [B, C, H, W], got {tuple(x.shape)}")
    if train:
        dims = (0, 2, 3) if x.dim() == 4 else (0,)
        if group is not None:
            return _batch_norm_global(p, x, dims, momentum, eps, group)
        with torch.no_grad():
            var, mean = torch.var_mean(x.to(torch.float32), dim=dims, correction=0)
            new = {"mean": momentum * p["mean"] + (1 - momentum) * mean,
                   "var": momentum * p["var"] + (1 - momentum) * var}
        # f32 statistics and arithmetic whatever x's dtype, one rounding to it
        y = F.batch_norm(x, None, None, p["gamma"], p["beta"], True, 0.0, eps)
        return y, new
    scale, shift = bn_fold(p, x, eps)
    return x * scale + shift


def bn_fold(p: dict, x: torch.Tensor, eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """The inference BN's (scale, shift) for x: folded from the running
    stats in f32, cast to x.dtype, shaped [C, 1, 1] (views of [C] tensors)
    for a 4-D x and [C] for a 2-D one; cached per (dtype, rank) in
    p["_folded"] unless the stats are being trained."""
    trained = p["var"].requires_grad or p["gamma"].requires_grad
    key = (x.dtype, x.dim())
    folded = None if trained else p.get("_folded", {}).get(key)
    if folded is None:
        r = torch.rsqrt(p["var"] + eps)
        scale = (p["gamma"] * r).to(x.dtype)
        shift = (p["beta"] - p["mean"] * p["gamma"] * r).to(x.dtype)
        if x.dim() == 4:
            scale, shift = scale[:, None, None], shift[:, None, None]
        folded = (scale, shift)
        if not trained:
            p.setdefault("_folded", {})[key] = folded
    return folded


def _batch_norm_global(p: dict, x: torch.Tensor, dims: tuple, momentum: float, eps: float,
                       group):
    """Training BN over the global batch of a data group (``batch_norm``)."""
    xf = x.to(torch.float32)
    count = (xf.numel() // xf.shape[1]) * dist.get_world_size(group)
    shape = (1, -1, 1, 1) if x.dim() == 4 else (1, -1)
    mean = reduce_sum(xf.sum(dim=dims), group) / count
    d = xf - mean.reshape(shape)
    var = reduce_sum((d * d).sum(dim=dims), group) / count
    y = d * torch.rsqrt(var + eps).reshape(shape) * p["gamma"].reshape(shape) \
        + p["beta"].reshape(shape)
    with torch.no_grad():
        new = {"mean": momentum * p["mean"] + (1 - momentum) * mean,
               "var": momentum * p["var"] + (1 - momentum) * var}
    return y.to(x.dtype), new


def prelu(p: dict, x: torch.Tensor) -> torch.Tensor:
    a = _cast(p, "alpha", x.dtype)[:, None, None]
    return torch.where(x >= 0, x, a * x)


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


_CONSTS: dict = {}  # (device, dtype, value) -> 0-d tensor, made once


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    key = (x.device, x.dtype, value)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(value, dtype=x.dtype, device=x.device)
    return t


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip: a max, then a min. At an exact tie with a bound the gradient
    splits in half, as JAX's does (``torch.clamp`` would pass all of it): a
    ReLU meets its bound at every exact zero, which a region of dead inputs
    gives, so the training gradients follow JAX's only with this rule."""
    return torch.minimum(torch.maximum(x, _const(x, lo)), _const(x, hi))


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, _const(x, 0.0))


def hswish(x: torch.Tensor) -> torch.Tensor:
    return x * _clip(x + 3.0, 0.0, 6.0) / 6.0


def hsigmoid(x: torch.Tensor) -> torch.Tensor:
    return _clip(x + 3.0, 0.0, 6.0) / 6.0


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w + b, with p["w"] stored [out, in]."""
    return F.linear(x, _cast(p, "w", x.dtype)) + _cast(p, "b", x.dtype)


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w.T, plus b where p has one, inside the GEMM; p["w"]
    stored [out, in]."""
    b = _cast(p, "b", x.dtype) if "b" in p else None
    return F.linear(x, _cast(p, "w", x.dtype), b)


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over x's last axis with p["gamma"] and p["beta"] cast to
    x's dtype (torch's kernel takes the statistics in f32)."""
    return F.layer_norm(x, x.shape[-1:], _cast(p, "gamma", x.dtype), _cast(p, "beta", x.dtype),
                        eps)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [B, C], mean in f32."""
    return x.to(torch.float32).mean(dim=(2, 3)).to(x.dtype)


def conv_bn(p: dict, x, stride=1, groups=1, act=None, padding="SAME"):
    y = conv(p["conv"], x, stride=stride, groups=groups, padding=padding)
    y = batch_norm(p["bn"], y)
    return act(y) if act is not None else y


def se_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    s = global_avg_pool(x)
    s = relu(dense(p["fc1"], s))
    s = hsigmoid(dense(p["fc2"], s))
    return x * s[:, :, None, None]


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit norm along the last axis."""
    return x * torch.rsqrt(torch.clamp((x * x).sum(dim=-1, keepdim=True), min=eps))


def upsample2x(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest upsample of NCHW x to out_hw with half-pixel centres (the
    ``jax.image.resize(..., "nearest")`` rule), also when out_hw is not an
    exact 2x."""
    return F.interpolate(x, size=tuple(out_hw), mode="nearest-exact")
