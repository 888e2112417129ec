"""Device ms a batch of the ViT embedder's ``frp.vit.sdpa`` spans in the
traced slice: the attention call alone of every block, nested in
``frp.vit.attn`` (``frp_tpu_torch/models/vit.py``), over the slice's batches (its
``frp.submit_encoded`` spans), a redo's included. None where the
program opens no such span."""

from perfbench.metrics._program import stage_ms


def read(run):
    return stage_ms(run, "frp.vit.sdpa")
