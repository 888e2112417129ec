"""Training checkpoint and resume for the port's trainers (the npz half of
``frp_tpu/train/checkpoint.py``).

A checkpoint holds a trainer state ({"params", "opt_state", "step"}) under
flat names: ``params/<a/b/0/w>`` in the port's layouts, ``opt/<a/b/0/w>/<buffer>``
for each of the optimizer's buffers of that parameter (SGD's
``momentum_buffer``; AdamW's ``step``, ``exp_avg``, ``exp_avg_sq``) and
``step``. It is written to a temporary file that then replaces ``path.npz``.

A trainer over a process mesh tags its state with the mesh (``state["mesh"]``)
and the names of its parameters split by columns over the model axis
(``state["model_columns"]``: the ArcFace classifier). Every rank then calls
``save_checkpoint``: those parameters and their buffers are gathered whole,
rank 0 alone writes the file (the names and shapes a one-card trainer
writes, the classes padded to the model axis), and every rank returns once
it is written. ``load_checkpoint`` gives each rank its columns of the file.
The JAX package's train-state checkpoints (orbax, or npz leaves in optax's
tree order) are not read: weights cross between the packages through
``models/params.save_params`` and ``load_params``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from frp_tpu_torch.models.params import flatten_params
from frp_tpu_torch.parallel.collectives import gather_columns
from frp_tpu_torch.parallel.mesh import MODEL_AXIS, model_columns
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


def column_split(state: dict, tensors: dict) -> list:
    """The names in ``tensors`` (``state_tensors``) of the state's
    parameters split by columns over the model axis, and of their
    optimizer buffers, in ``tensors``' order: every rank gathers them in
    the same order."""
    split = state.get("model_columns", ()) if state.get("mesh") else ()
    return [k for k in tensors if k.split("/")[1] in split]


def _written(mesh) -> None:
    """Every rank waits here until rank 0 has written (an all_reduce: the
    collective that every backend takes on every device)."""
    dist.all_reduce(torch.zeros(1, device=mesh.device))


def save_checkpoint(path: str, state: dict) -> str:
    """Save a trainer state to ``path.npz``; returns the format, "npz". A
    process mesh's state is saved by every rank together (module doc)."""
    mesh = state.get("mesh")
    tensors = state_tensors(state)
    if mesh is not None:
        for k in column_split(state, tensors):
            tensors[k] = gather_columns(tensors[k], mesh)
        if dist.get_rank() != 0:
            _written(mesh)
            return "npz"
    flat = {k: v.detach().cpu().numpy() for k, v in tensors.items()}
    flat["step"] = np.asarray(state["step"], np.int64)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    tmp = path + ".npz.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path + ".npz")
    if mesh is not None:
        _written(mesh)
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
    mesh = like.get("mesh")
    split = column_split(like, want)
    for k, t in want.items():
        shape = tuple(t.shape)
        if k in split:  # the file holds every model position's columns
            shape = (*shape[:-1], shape[-1] * mesh.shape[MODEL_AXIS])
        if tuple(got[k].shape) != shape:
            logger.warning("checkpoint %s: %s has shape %s, the target %s (different "
                           "config?); refusing to restore", npz, k, got[k].shape, shape)
            return None
    with torch.no_grad():
        for k, t in want.items():
            src = got[k]
            if k in split:
                cols = model_columns(src.shape[-1], mesh)[mesh.position[1]]
                src = np.ascontiguousarray(src[..., cols])
            t.copy_(torch.from_numpy(src))
    like["step"] = int(step)
    return like
