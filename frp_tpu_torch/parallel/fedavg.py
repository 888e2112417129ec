"""Sharded FedAvg (port of ``frp_tpu/parallel/fedavg.py``): client updates
split over the mesh's data axis, a weighted partial sum in f32 for each data
position, and the partials added into the FedAvg result, the same math as
``frp_tpu_torch.ops.fedavg.fedavg_tree``.

Shape contract: client updates stacked on a leading K axis (K = number of
clients, padded to a multiple of the data axis with zero-weight clients,
``pad_clients``). On a single-process mesh each position takes K/n_data
contiguous clients on its device and the partials are added in position
order on the first position's device. On a process mesh each process passes
its own position's clients and their weights (the global stack is their
concatenation in data order, as ``jax.make_array_from_process_local_data``
takes a process's rows) and one ``all_reduce`` over the data group adds the
partials.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from frp_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, data_rows


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def _partial(leaf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # weight math in f32: .to(leaf.dtype) on an int leaf would truncate 1/K
    # weights to zero and silently null the average
    wl = w.to(torch.float32).reshape((-1,) + (1,) * (leaf.dim() - 1))
    return torch.sum(leaf.to(torch.float32) * wl, dim=0)


def fedavg_sharded(mesh: Mesh, stacked: dict, weights) -> dict:
    """FedAvg over a mesh.

    Args:
        mesh: a single-process or a process mesh (its 'data' axis).
        stacked: {layer: [K, ...] tensor or array} (see the module's shape
            contract for what K is on a process mesh).
        weights: [K] weights (this position's rows on a process mesh),
            summing to 1 over the global stack.
    Returns {layer: [...] tensor}, each in its leaf's dtype: on the first
    position's device, or on this process's device on a process mesh."""
    w = _as_tensor(weights)
    leaves = {name: _as_tensor(leaf) for name, leaf in stacked.items()}
    if mesh.is_process_mesh:
        dev = mesh.device
        group = mesh.get_group(DATA_AXIS)
        out = {}
        for name, leaf in leaves.items():
            part = _partial(leaf.to(dev), w.to(dev))
            dist.all_reduce(part, group=group)
            out[name] = part.to(leaf.dtype)
        return out
    rows = data_rows(int(w.shape[0]), mesh, "client stack")
    devices = [mesh.devices[i, 0] for i in range(len(rows))]
    out = {}
    for name, leaf in leaves.items():
        parts = [_partial(leaf[r].to(d), w[r].to(d)) for r, d in zip(rows, devices)]
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(devices[0])
        out[name] = total.to(leaf.dtype)
    return out


def pad_clients(stacked: dict, weights, multiple: int):
    """Pad the client axis to a multiple of ``multiple`` with zero-weight
    clients (zeros of each leaf's dtype)."""
    w = _as_tensor(weights)
    pad = (-int(w.shape[0])) % multiple
    if pad == 0:
        return stacked, weights
    padded = {}
    for name, leaf in stacked.items():
        t = _as_tensor(leaf)
        padded[name] = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))], dim=0)
    return padded, torch.cat([w, w.new_zeros((pad,))])
