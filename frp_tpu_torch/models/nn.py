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
import torch.nn.functional as F

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
               eps: float = 1e-5):
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
    them as an auxiliary output, which its gradient does not reach)."""
    if x.dim() not in (2, 4):
        raise ValueError(f"batch_norm takes [B, C] or [B, C, H, W], got {tuple(x.shape)}")
    if train:
        dims = (0, 2, 3) if x.dim() == 4 else (0,)
        with torch.no_grad():
            var, mean = torch.var_mean(x.to(torch.float32), dim=dims, correction=0)
            new = {"mean": momentum * p["mean"] + (1 - momentum) * mean,
                   "var": momentum * p["var"] + (1 - momentum) * var}
        # f32 statistics and arithmetic whatever x's dtype, one rounding to it
        y = F.batch_norm(x, None, None, p["gamma"], p["beta"], True, 0.0, eps)
        return y, new
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
    scale, shift = folded
    return x * scale + shift


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
