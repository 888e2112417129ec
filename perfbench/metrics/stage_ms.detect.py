"""Device ms a batch of the engine's ``frp.detect`` stage in the traced
slice: the kernels and copies launched inside its spans, over the
slice's batches (its ``frp.submit_encoded`` spans)."""

from perfbench.metrics._program import stage_ms


def read(run):
    return stage_ms(run, "frp.detect")
