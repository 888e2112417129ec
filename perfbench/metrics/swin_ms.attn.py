"""Device ms a batch of the Swin embedder's ``frp.swin.attn`` spans in the
traced slice: the attention half of every block: the window gather,
qkv, the attention, proj, the reverse gather and the add with LN2
(``frp_tpu_torch/models/swin.py``), over the slice's batches (its
``frp.submit_encoded`` spans), a redo's included. None where the
program opens no such span."""

from perfbench.metrics._program import stage_ms


def read(run):
    return stage_ms(run, "frp.swin.attn")
