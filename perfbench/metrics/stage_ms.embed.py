"""Device ms a batch of the engine's ``frp.embed`` stage in the traced
slice, the embedder and the spoof net, a redo's included: the kernels and
copies launched inside its spans, over the slice's batches (its
``frp.submit_encoded`` spans)."""

from perfbench.metrics._program import stage_ms


def read(run):
    return stage_ms(run, "frp.embed")
