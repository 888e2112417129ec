"""Spoof/deepfake classifier training: cross-entropy for the MobileNetV3-Small
head on one card (port of ``frp_tpu/train/classifier.py``).

The forward runs BN in inference mode, as ``mobilenetv3_forward`` always
does, so the BN running ``mean`` and ``var`` are trained as parameters: the
gradient reaches them through the folded scale and shift, and AdamW updates
them. AdamW at optax's defaults: betas (0.9, 0.999), eps 1e-8, weight decay
1e-4 on every leaf (torch's own default decay is 1e-2).

Over a process mesh (data-parallel, as the JAX trainer's ``mesh=``): the
parameters are replicated, each rank takes its data position's rows of the
global batch, the gradients are averaged over the data positions (over
every rank: ``MeshSplit.average_gradients``) before AdamW, and the metrics
are the global batch's means.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from frp_tpu_torch.models.mobilenetv3 import init_mobilenetv3_small, mobilenetv3_forward
from frp_tpu_torch.models.params import to_numpy_params
from frp_tpu_torch.ops.image import normalize_imagenet
from frp_tpu_torch.train.arcface import (
    MeshSplit,
    fetch_metrics,
    leaves,
    to_device_batch,
    trainable,
    trainer_device,
)


def adamw(params, learning_rate: float) -> torch.optim.AdamW:
    """``optax.adamw(learning_rate)`` over every leaf, its moments at zero."""
    opt = torch.optim.AdamW(leaves(params), lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    for p in leaves(params):
        opt.state[p].update(step=torch.tensor(0.0), exp_avg=torch.zeros_like(p),
                            exp_avg_sq=torch.zeros_like(p))
    return opt


class SpoofTrainer:
    def __init__(
        self,
        mesh=None,
        seed: int = 0,
        learning_rate: float = 1e-3,
        compute_dtype: str = "bfloat16",
        device=None,
    ):
        self.split = split = MeshSplit(mesh, "spoof training")
        self.device = trainer_device(mesh, device)
        cdtype = getattr(torch, compute_dtype)
        params = trainable(init_mobilenetv3_small(seed, num_classes=2), self.device)
        self.optimizer = adamw(params, learning_rate)
        self.state = self.split.tag({"params": params, "opt_state": self.optimizer, "step": 0})

        def step(state, images, labels):
            self.optimizer.zero_grad(set_to_none=False)
            x = normalize_imagenet(images).to(cdtype)
            logits = mobilenetv3_forward(state["params"], x)
            loss = F.cross_entropy(logits, labels)
            loss.backward()
            split.average_gradients(leaves(state["params"]))
            self.optimizer.step()
            state["step"] += 1
            with torch.no_grad():
                acc = (logits.argmax(dim=-1) == labels).to(torch.float32).mean()
            return state, {"loss": split.mean(loss.detach()), "accuracy": split.mean(acc)}

        self._step = step
        self.history: list[dict] = []

    def train_step(self, images, labels) -> dict:
        """images [B, S, S, 3] float 0..255 crops; labels [B] (1 = fake);
        over a mesh, the global batch."""
        rows = self.split.rows
        self.state, metrics = self._step(
            self.state,
            to_device_batch(rows(images), self.device, torch.float32),
            to_device_batch(rows(labels), self.device, torch.int64),
        )
        entry = fetch_metrics([metrics])[0]  # one fetch a step
        entry["step"] = self.state["step"]
        self.history.append(entry)
        return entry

    def classifier_params(self):
        """The classifier as a numpy tree in the JAX layouts."""
        return to_numpy_params(self.state["params"])
