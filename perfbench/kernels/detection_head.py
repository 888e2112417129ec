"""Kernel 1, the fused detection head (``frp_tpu_torch/csrc/detection_head.cu``):
per frame the top-K candidates' decode, the effective overlap of every pair,
the greedy pass and the M kept slots. Reads the [B, K, 19] f32 candidate
payload once and writes the [B, M, 16] f32 slots once; operations as
``chip_smoke.py::hold_head`` counts them: 20 a candidate pair (19 of the
effective overlap, one compare) and 70 a candidate for the decode."""

NAME = "detection_head"
PATTERN = r"\bdetection_head_kernel\b"


def work(shapes: dict) -> tuple[float, float]:
    b, k, m = shapes["B"], shapes["K"], shapes["M"]
    nbytes = b * k * 19 * 4 + b * m * 16 * 4
    ops = b * k * (k - 1) / 2 * 20 + b * k * 70
    return nbytes, ops
