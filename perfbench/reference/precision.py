"""Rounding for the control: the reference computed one precision below the
bfloat16 the configurations state, as fp8 (e4m3) matmul inputs with a
scale per tensor, the step a later change to the program could be tempted
to take. Each conv or dense input and weight is scaled so that its largest
magnitude lands on e4m3's largest finite value, rounded to e4m3, and
scaled back; the arithmetic itself stays float32."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax()
    if not bool(amax > 0):
        return x
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


ROUNDING = {"float32": identity, "fp8": fp8}
