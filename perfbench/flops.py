"""Useful model FLOPs of a batch, counted by ``FlopCounterMode`` over the
benchmark's own reference networks (``perfbench/reference/``) on
meta tensors: the detector at each frame's full square, the embedder and
the spoof net at each valid face, and each face's match against every
gallery entry. They count the work the results need, whatever implements
it: no padding slots, no compaction rung, no redone batch.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import embedders, nets
from perfbench.reference.pipeline import load_npz

PEAK_BF16_DENSE = 989e12  # one H100 SXM, bf16 dense, at 700 W


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def per_frame_and_face(cfg: dict, weights_dir: str, gallery_size: int) -> tuple[int, int]:
    """(FLOPs of one frame's detection, FLOPs of one valid face: embedder,
    spoof net and its match over the gallery)."""
    meta = torch.device("meta")
    files = cfg["weights"]
    det = load_npz(f"{weights_dir}/{files['detector']}", meta)
    emb = load_npz(f"{weights_dir}/{files['embedder']}", meta)
    spoof = load_npz(f"{weights_dir}/{files['spoof']}", meta)
    s, c, d = cfg["det_size"], cfg["crop_size"], cfg["embed_dim"]
    frame = torch.zeros((1, s, s, 3), device=meta)
    crop = torch.zeros((1, c, c, 3), device=meta)
    q, g = torch.zeros((1, d), device=meta), torch.zeros((gallery_size, d), device=meta)
    f_det = _count(lambda: nets.retinaface(det, frame))
    embed = embedders.resolve(cfg["embedder_arch"]).forward
    f_face = (_count(lambda: embed(emb, crop))
              + _count(lambda: nets.mobilenetv3(spoof, crop))
              + _count(lambda: q @ g.T))
    return f_det, f_face
