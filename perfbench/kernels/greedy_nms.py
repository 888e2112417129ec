"""Kernel 3, the greedy suppression pass (``frp_tpu_torch/csrc/greedy_nms.cu``)
of ``nms_padded_batched``: keeps a rank when no kept higher rank overlaps
it. Reads the f32 overlaps of the K (K - 1) / 2 pairs j > i a frame and the
[B, K] above flags once and writes the [B, K] keep flags once; one compare
a pair. The serving path's fused head does not launch it at K <= 256."""

NAME = "greedy_nms"
PATTERN = r"\bgreedy_nms_kernel\b"


def work(shapes: dict) -> tuple[float, float]:
    b, k = shapes["B"], shapes["K"]
    pairs = b * k * (k - 1) / 2
    return pairs * 4 + 2 * b * k, pairs
