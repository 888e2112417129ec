"""Training on the card: ArcFace for the embedders, the spoof and detector
trainers, checkpoints, synthetic data and pair metrics (port of
``frp_tpu/train``). Every trainer means the card unless given a device."""

from frp_tpu_torch.train.arcface import (
    ArcFaceTrainer,
    arcface_logits,
    init_train_state,
    make_train_step,
)
