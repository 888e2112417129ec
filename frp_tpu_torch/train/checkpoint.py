"""Training checkpoint and resume for the port's trainers (the npz half of
``frp_tpu/train/checkpoint.py``).

A checkpoint holds a trainer state ({"params", "opt_state", "step"}) under
flat names: ``params/<a/b/0/w>`` in the port's layouts, ``opt/<a/b/0/w>/<buffer>``
for each of the optimizer's buffers of that parameter (SGD's
``momentum_buffer``; AdamW's ``step``, ``exp_avg``, ``exp_avg_sq``) and
``step``. It is written to a temporary file that then replaces ``path.npz``.
The JAX package's train-state checkpoints (orbax, or npz leaves in optax's
tree order) are not read: weights cross between the packages through
``models/params.save_params`` and ``load_params``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from frp_tpu_torch.models.params import flatten_params
from frp_tpu_torch.utils.logger import get_logger

logger = get_logger("frp.train.checkpoint")


def state_tensors(state: dict) -> dict:
    """{flat name: tensor} of a trainer state, the step left out."""
    params = flatten_params(state["params"])
    out = {f"params/{k}": v for k, v in params.items()}
    opt = state["opt_state"]
    for name, p in params.items():
        for key, buf in opt.state[p].items():
            out[f"opt/{name}/{key}"] = buf
    return out


def save_checkpoint(path: str, state: dict) -> str:
    """Save a trainer state to ``path.npz``; returns the format, "npz"."""
    flat = {k: v.detach().cpu().numpy() for k, v in state_tensors(state).items()}
    flat["step"] = np.asarray(state["step"], np.int64)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    tmp = path + ".npz.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path + ".npz")
    return "npz"


def load_checkpoint(path: str, like: dict | None = None) -> dict | None:
    """Restore ``path.npz`` into the state ``like`` (in place) and return it;
    None when the file is absent or ``like`` is not given. A file whose names
    or shapes differ from ``like``'s (another run's configuration) is
    refused with a warning and None, and ``like`` is left as it was."""
    npz = path + ".npz"
    if like is None or not os.path.exists(npz):
        return None
    want = state_tensors(like)
    with np.load(npz, allow_pickle=False) as data:
        got = {k: data[k] for k in data.files}
    step = got.pop("step", None)
    if step is None or got.keys() != want.keys():
        logger.warning("checkpoint %s holds other names than the target state (%d and %d "
                       "arrays; different config?); refusing to restore",
                       npz, len(got), len(want))
        return None
    for k, t in want.items():
        if tuple(got[k].shape) != tuple(t.shape):
            logger.warning("checkpoint %s: %s has shape %s, the target %s (different "
                           "config?); refusing to restore", npz, k, got[k].shape, tuple(t.shape))
            return None
    with torch.no_grad():
        for k, t in want.items():
            t.copy_(torch.from_numpy(got[k]))
    like["step"] = int(step)
    return like
