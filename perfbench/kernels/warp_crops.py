"""Kernel 2, the crop warp (``frp_tpu_torch/csrc/warp_crops.cu``): M crops of
C x C x 3 a frame, bilinear through each face's inverse similarity. Reads
the [B, S, S, 3] uint8 frames and the [B, M, 2, 3] f32 matrices once and
writes the [B, M, C, C, 3] f32 crops once; operations as
``chip_smoke.py``'s warp check counts them: 14 an output pixel for its
sample coordinate, clamp, floor and weights, 6 a channel for the blend."""

NAME = "warp_crops"
PATTERN = r"\bwarp_crops_kernel\b"


def work(shapes: dict) -> tuple[float, float]:
    b, m, s, c = shapes["B"], shapes["M"], shapes["S"], shapes["C"]
    nbytes = b * s * s * 3 + b * m * 6 * 4 + b * m * c * c * 3 * 4
    ops = b * m * c * c * (14 + 3 * 6)
    return nbytes, ops
