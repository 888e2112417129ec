"""The port's training entry points, run as ``python -m
frp_tpu_torch.tools.<name>``: pretrain_embedder, pretrain_spoof,
pretrain_synthetic and fl_client (ports of the JAX package's ``tools/``
scripts, with their arguments, plus ``--device``: the card unless named)."""
