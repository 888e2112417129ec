"""The port's tools, run as ``python -m frp_tpu_torch.tools.<name>`` (ports
of the JAX package's ``tools/`` scripts, with their arguments, plus
``--device`` where a tool runs a model: the card unless named). Training:
pretrain_embedder, pretrain_spoof, pretrain_synthetic, fl_client. A site's
own weights: import_real_weights (validate, install, re-measure),
calibrate_embedder, tiered_eval, eval_spoof, migrate_retinaface_npz.
Serving: demo_server, mock_camera_worker."""
