"""The hand-written kernels' share of their roofline in the traced slice,
in %: the sum over their launches of the least time the card could take
(the larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s, counted
from the cell's shapes by ``perfbench/kernels/<kernel>.py``) over the sum
of their measured device time. None where no such kernel ran."""

import re

from perfbench import common

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def roofline_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def read(run):
    dt = run["trace"]
    if dt is None:
        return None
    least = spent = 0.0
    for k in common.kernel_counts():
        pat = re.compile(k.PATTERN)
        hits = [e for e in dt.kernels() if pat.search(e[0])]
        if hits:
            least += len(hits) * roofline_s(*k.work(run["shapes"]))
            spent += sum(e[2] - e[1] for e in hits)
    if not spent:
        return None
    return 100.0 * least / spent
