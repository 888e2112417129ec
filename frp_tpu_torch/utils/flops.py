"""Model-FLOPs accounting for MFU reporting (port of ``frp_tpu/utils/flops.py``).

The JAX package prices the compiled program with XLA's cost analysis
(``compiled_flops``). The port counts with
``torch.utils.flop_counter.FlopCounterMode`` (``counted_flops``), which
counts the matrix products and convolutions that PyTorch runs, forward and
backward, at 2 per multiply-add, and nothing else: element-wise work,
reductions, gathers, and the hand-written CUDA kernels (launched through
``ctypes``, out of its sight) add nothing. On MobileFaceNet XLA's count is
about 3 % larger, for the element-wise ops it prices too.

MFU is model-FLOPs utilization against the card's dense bf16 peak
(``PEAK_FLOPS_BF16``): FLOPs over device-busy time says how well the work
maps onto the tensor cores while the card runs, FLOPs over the wall time of
a batch the end-to-end duty cycle.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA H100 SXM: 989 TFLOP/s dense bf16 on the tensor cores (NVIDIA's
# data sheet, at the 700 W power limit)
PEAK_FLOPS_BF16 = 989e12


def counted_flops(fn, *args, **kwargs) -> float:
    """FLOPs of one call ``fn(*args, **kwargs)`` as FlopCounterMode counts
    them (matmuls and convolutions, backward included when the call runs
    one). The call runs for real, on the arguments' device. The counterpart
    of the JAX package's ``compiled_flops``, which prices every op of the
    compiled program instead."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def conv_flops(out_hw, kh, kw, cin, cout, groups: int = 1) -> float:
    """Multiply-accumulates x2 for one conv layer."""
    oh, ow = out_hw
    return 2.0 * oh * ow * kh * kw * (cin // groups) * cout


def dense_flops(cin, cout) -> float:
    return 2.0 * cin * cout


def engine_stage_flops(engine, batch: int, occupancy: int | None = None) -> dict:
    """FLOPs of one dispatch of each device stage of a RecognitionEngine for
    a batch of ``batch`` frames at its production shapes (det square, M
    slots, 112 px crops, its gallery), counted on the engine's device.
    Returns {"detect", "crop", "embed", "match", "total"}.

    The embed figure is that of the uncompacted stage. ``occupancy``: valid
    faces a batch; where the engine compacts the valid slots
    (``embed_compact_rungs``), the embed figure is scaled by rung / n for
    the rung the host picks for that many, the work that runs."""
    from frp_tpu_torch.engine.pipeline import embed_compact_rungs

    cfg = engine.cfg
    s, m = cfg.det_size, cfg.max_faces_per_frame
    dev = engine.device
    stages, params = engine._stages, engine.params
    n = batch * m
    f32 = dict(dtype=torch.float32, device=dev)
    out: dict = {}
    with torch.no_grad():
        frames = torch.zeros((batch, s, s, 3), dtype=torch.uint8, device=dev)
        out["detect"] = counted_flops(stages["detect"], params["detector"], frames, engine._priors)
        dets = {
            "boxes": torch.zeros((batch, m, 4), **f32),
            "scores": torch.zeros((batch, m), **f32),
            "landmarks": torch.zeros((batch, m, 10), **f32),
            "valid": torch.zeros((batch, m), dtype=torch.bool, device=dev),
            "count": torch.zeros((batch,), dtype=torch.int32, device=dev),
        }
        out["crop"] = counted_flops(stages["crop"], frames, dets)
        crops = torch.zeros((batch, m, 112, 112, 3), **f32)
        embed = counted_flops(_plain_embed_stage(engine), params, crops, dets["valid"],
                              engine.distance_scale)
        rungs = embed_compact_rungs(n)
        if rungs and occupancy is not None:
            embed *= next((r for r in rungs if occupancy <= r), n) / n
        out["embed"] = embed
        gal, gal_valid, _names = engine.gallery.device_view()
        out["match"] = counted_flops(
            stages["match"], torch.zeros((n, cfg.embed_dim), **f32), dets["valid"],
            gal, gal_valid, float(cfg.face_tolerance))
    out["total"] = float(sum(out.values()))
    return out


def _plain_embed_stage(engine):
    """An uncompacted embed stage of the engine's config, for counting."""
    from frp_tpu_torch.engine.pipeline import build_stages

    cfg = engine.cfg
    return build_stages(
        device=engine.device, det_size=cfg.det_size, max_faces=cfg.max_faces_per_frame,
        with_spoof=engine.with_spoof, compute_dtype=cfg.compute_dtype,
        embedder_forward=engine._embedder_forward, flip_tta=cfg.embed_flip_tta,
        compact=False)["embed"]


def mfu(flops_per_step: float, seconds_per_step: float,
        peak: float = PEAK_FLOPS_BF16) -> float:
    """Model-FLOPs utilization in [0, 1]."""
    if not flops_per_step or seconds_per_step <= 0:
        return 0.0
    return float(flops_per_step) / seconds_per_step / peak
