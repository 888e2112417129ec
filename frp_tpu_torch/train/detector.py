"""RetinaFace detector training: the batched multibox loss and its step on
one card (port of ``frp_tpu/train/detector.py``).

The forward runs BN in inference mode, as ``retinaface_forward`` always does,
so the BN running ``mean`` and ``var`` are trained as parameters. The update
is optax's ``chain(clip_by_global_norm(10), adamw(lr))``: the gradients are
scaled by max_norm / norm only when the global norm exceeds max_norm (optax's
rule; ``clip_grad_norm_`` would divide by norm + 1e-6 always), then AdamW at
optax's defaults.

Over a process mesh (data-parallel, as the JAX trainer's ``mesh=``): the
parameters are replicated, each rank takes its data position's rows of the
global batch, and the gradients are averaged over the data positions (over
every rank: ``MeshSplit.average_gradients``) before the clip, so that the
clip sees the global gradient's norm; the metrics are the global batch's
means.
"""

from __future__ import annotations

import torch

from frp_tpu_torch.models.params import to_numpy_params
from frp_tpu_torch.models.retinaface import init_retinaface, retinaface_forward
from frp_tpu_torch.ops.anchor_targets import assign_targets, multibox_loss
from frp_tpu_torch.ops.anchors import generate_anchors
from frp_tpu_torch.train.arcface import (
    MeshSplit,
    fetch_metrics,
    leaves,
    to_device_batch,
    trainable,
    trainer_device,
)
from frp_tpu_torch.train.classifier import adamw


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm, in place and without a host sync: g stays
    where the global norm is below max_norm, else g / norm * max_norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, factor)


def make_detector_train_step(optimizer, mesh=None, compute_dtype: str = "bfloat16",
                             pos_thresh: float = 0.35):
    """step(state, images, gt_boxes, gt_ldm, gt_valid, priors) -> (state,
    metrics): the per-image losses' batch means, 0-d tensors on the device.
    Over a process ``mesh`` the step takes this rank's rows of the global
    batch (``MeshSplit.rows``) and its metrics are the global batch's."""
    split = MeshSplit(mesh, "detector training")
    cdtype = getattr(torch, compute_dtype)

    def step(state, images, gt_boxes, gt_ldm, gt_valid, priors):
        params = state["params"]
        optimizer.zero_grad(set_to_none=False)
        out = retinaface_forward(params, ((images - 127.5) / 128.0).to(cdtype))
        t = assign_targets(priors, gt_boxes, gt_ldm, gt_valid, pos_thresh, pos_thresh)
        losses = multibox_loss(out["loc"], out["ldm"], out["cls_logits"], t)
        loss = losses["loss"].mean()
        loss.backward()
        split.average_gradients(leaves(params))
        clip_by_global_norm([p.grad for p in leaves(params)], 10.0)
        optimizer.step()
        state["step"] += 1
        return state, {k: split.mean(v.detach().mean()) for k, v in losses.items()}

    return step


class DetectorTrainer:
    """Host-facing detector trainer (ArcFaceTrainer's surface)."""

    def __init__(
        self,
        det_size: int = 320,
        mesh=None,
        seed: int = 0,
        learning_rate: float = 1e-3,
        compute_dtype: str = "bfloat16",
        device=None,
    ):
        self.split = MeshSplit(mesh, "detector training")
        self.det_size = det_size
        self.device = trainer_device(mesh, device)
        self.priors = torch.from_numpy(generate_anchors(det_size).copy()).to(self.device)
        params = trainable(init_retinaface(seed), self.device)
        self.optimizer = adamw(params, learning_rate)
        self.state = self.split.tag({"params": params, "opt_state": self.optimizer, "step": 0})
        self._step = make_detector_train_step(self.optimizer, mesh, compute_dtype=compute_dtype)
        self.history: list[dict] = []

    def train_step(self, images, gt_boxes, gt_ldm, gt_valid) -> dict:
        """images [B, S, S, 3] float 0..255; gt_boxes [B, G, 4] xyxy
        normalized 0..1; gt_ldm [B, G, 10] normalized; gt_valid [B, G]; over
        a mesh, the global batch."""
        dev, rows = self.device, self.split.rows
        self.state, metrics = self._step(
            self.state,
            to_device_batch(rows(images), dev, torch.float32),
            to_device_batch(rows(gt_boxes), dev, torch.float32),
            to_device_batch(rows(gt_ldm), dev, torch.float32),
            to_device_batch(rows(gt_valid), dev, torch.bool),
            self.priors,
        )
        entry = fetch_metrics([metrics])[0]  # one fetch a step
        entry["step"] = self.state["step"]
        self.history.append(entry)
        return entry

    def detector_params(self):
        """The detector as a numpy tree in the JAX layouts."""
        return to_numpy_params(self.state["params"])
