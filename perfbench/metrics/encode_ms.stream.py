"""The producer thread's host encoder a batch (``LetterboxCache.update``,
``dirty_blocks`` and ``DeltaEncoder.encode``; not the scene's motion),
from the harness's ``encode`` spans over the window, in ms."""

from perfbench.metrics._spans import per_call_ms


def read(run):
    lo, hi = run["window"]
    return per_call_ms(run["spans"].items, "encode", lo, hi, per=len(run["batches"]))
