"""Device ms a batch of the Swin embedder's ``frp.swin.sdpa`` spans in the
traced slice: every block's attention calls alone, one a run of windows
sharing a bias, nested in ``frp.swin.attn``
(``frp_tpu_torch/models/swin.py``), over the slice's batches (its
``frp.submit_encoded`` spans), a redo's included. None where the
program opens no such span."""

from perfbench.metrics._program import stage_ms


def read(run):
    return stage_ms(run, "frp.swin.sdpa")
