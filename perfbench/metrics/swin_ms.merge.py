"""Device ms a batch of the Swin embedder's ``frp.swin.merge`` spans in the
traced slice: each patch merging between stages (the 2x2 gather, LN(4C)
and the linear to 2C)
(``frp_tpu_torch/models/swin.py``), over the slice's batches (its
``frp.submit_encoded`` spans), a redo's included. None where the
program opens no such span."""

from perfbench.metrics._program import stage_ms


def read(run):
    return stage_ms(run, "frp.swin.merge")
