"""Device ms a batch of the Swin embedder's ``frp.swin.window`` spans in the
traced slice: the roll and window cut of every block's LN1 output and
the reverse with the roll back, in stages 1-3, nested in ``frp.swin.attn``
(``frp_tpu_torch/models/swin.py``), over the slice's batches (its
``frp.submit_encoded`` spans), a redo's included. None where the
program opens no such span."""

from perfbench.metrics._program import stage_ms


def read(run):
    return stage_ms(run, "frp.swin.window")
