"""The hand-written kernels' share of their roofline in the traced slice,
in %: the sum over their launches of the least time the card could take
(the larger of bytes over 3.35 TB/s and operations over the kernel's peak,
counted from the cell's shapes by ``perfbench/kernels/<kernel>.py``) over
the sum of their measured device time. None where no such kernel ran.

A kernel's peak is its counts file's ``PEAK_OPS_PER_S``, one of the H100
SXM data sheet's dense rates (fp8 and int8 1979, bf16 and fp16 989, TF32
495, float32 outside the tensor cores 67 TFLOP/s); a file that sets none
is counted at the float32 rate."""

import re

from perfbench import common

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
DATA_SHEET_OPS_PER_S = (1979e12, 989e12, 495e12, F32_OPS_PER_S)


def roofline_s(nbytes: float, ops: float, peak: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def read(run):
    dt = run["trace"]
    if dt is None:
        return None
    least = spent = 0.0
    for k in common.kernel_counts():
        peak = getattr(k, "PEAK_OPS_PER_S", F32_OPS_PER_S)
        if peak not in DATA_SHEET_OPS_PER_S:
            raise SystemExit(f"{k.__file__}: PEAK_OPS_PER_S {peak:g} is not one of the data "
                             f"sheet's rates {', '.join(f'{r:g}' for r in DATA_SHEET_OPS_PER_S)}")
        pat = re.compile(k.PATTERN)
        hits = [e for e in dt.kernels() if pat.search(e[0])]
        if hits:
            least += len(hits) * roofline_s(*k.work(run["shapes"]), peak)
            spent += sum(e[2] - e[1] for e in hits)
    if not spent:
        return None
    return 100.0 * least / spent
