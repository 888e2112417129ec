"""Device ms a batch of the Swin embedder's ``frp.swin.mlp`` spans in the
traced slice: fc1, GELU, fc2 and the residual add of every block
(``frp_tpu_torch/models/swin.py``), over the slice's batches (its
``frp.submit_encoded`` spans), a redo's included. None where the
program opens no such span."""

from perfbench.metrics._program import stage_ms


def read(run):
    return stage_ms(run, "frp.swin.mlp")
