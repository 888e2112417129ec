"""FedAvg math, the host half (port of ``frp_tpu/ops/fedavg.py``) — the
reference's per-layer weighted accumulation
(``backend/app/routes/federated.py:577-700``).

Semantics preserved exactly:
  * NaN/Inf in a client update is rejected up front (federated.py:163-171).
  * Layer-name sets must match across clients (federated.py:598-602).
  * Weighting: equal 1/K, or contribution-proportional c_k / sum(c)
    (federated.py:605-612).
  * Per-layer shape consistency is enforced (federated.py:617-630).

``fedavg_combine`` runs on host numpy arrays in float64 (the HTTP JSON
path, and the only one ``platform/federated.py`` takes). ``fedavg_tree`` is
the same weighted sum over a dict of stacked torch tensors;
``parallel/fedavg.py::fedavg_sharded`` splits it over a mesh.
"""

from __future__ import annotations

import numpy as np
import torch


class FedAvgError(ValueError):
    pass


def validate_client_update(update: dict) -> dict:
    """Validate a {layer_name: array-like} client update.

    Returns {"layers": [...], "shapes": {...}, "total_params": int}.
    Raises FedAvgError on empty/NaN/Inf/non-numeric payloads.
    """
    if not isinstance(update, dict) or not update:
        raise FedAvgError("weights must be a non-empty dict of layers")
    shapes = {}
    total = 0
    for name, arr in update.items():
        try:
            a = np.asarray(arr, dtype=np.float64)
        except (TypeError, ValueError) as e:
            raise FedAvgError(f"layer '{name}' is not numeric: {e}") from e
        if a.size == 0:
            raise FedAvgError(f"layer '{name}' is empty")
        if not np.all(np.isfinite(a)):
            raise FedAvgError(f"layer '{name}' contains NaN or Inf values")
        shapes[name] = list(a.shape)
        total += int(a.size)
    return {"layers": sorted(update.keys()), "shapes": shapes, "total_params": total}


def resolve_weights(
    client_ids: list, contributions: dict | None = None, proportional: bool = False
) -> dict:
    """Per-client scalar weights: equal or contribution-proportional."""
    k = len(client_ids)
    if k == 0:
        raise FedAvgError("no clients to aggregate")
    if proportional and contributions:
        counts = {c: max(float(contributions.get(c, 0.0)), 0.0) for c in client_ids}
        total = sum(counts.values())
        if total <= 0:
            return {c: 1.0 / k for c in client_ids}
        return {c: counts[c] / total for c in client_ids}
    return {c: 1.0 / k for c in client_ids}


def check_layer_consistency(updates: dict) -> list:
    """All clients must expose identical layer-name sets; returns sorted names."""
    if not updates:
        # a bare next() would raise StopIteration, bypassing callers'
        # except FedAvgError handling (platform/federated.py)
        raise FedAvgError("no client updates to aggregate")
    its = iter(updates.items())
    first_client, first = next(its)
    names = set(first.keys())
    for cid, upd in its:
        if set(upd.keys()) != names:
            raise FedAvgError(
                f"layer structure mismatch: client '{cid}' differs from '{first_client}'"
            )
    return sorted(names)


def fedavg_combine(updates: dict, weights: dict) -> dict:
    """Weighted per-layer average in float64: {layer: sum_k w_k * arr_k}.

    Args:
        updates: {client_id: {layer: array}}.
        weights: {client_id: float} (should sum to 1).
    """
    names = check_layer_consistency(updates)
    clients = list(updates.keys())
    out = {}
    for name in names:
        ref_shape = np.asarray(updates[clients[0]][name]).shape
        acc = None
        for cid in clients:
            arr = np.asarray(updates[cid][name], dtype=np.float64)
            if tuple(arr.shape) != tuple(ref_shape):
                raise FedAvgError(
                    f"shape mismatch for layer '{name}': client '{cid}' has "
                    f"{tuple(arr.shape)} vs {tuple(ref_shape)}"
                )
            term = arr * weights[cid]
            acc = term if acc is None else acc + term
        out[name] = acc
    return out


def fedavg_tree(stacked: dict, weights: torch.Tensor) -> dict:
    """FedAvg over stacked client updates.

    Args:
        stacked: {layer: tensor [K, ...]} — K client updates stacked on a
            leading axis.
        weights: [K] float weights summing to 1.
    Returns {layer: tensor [...]} — the weighted average, in each layer's
    dtype.
    """
    def combine(leaf):
        w = weights.reshape((-1,) + (1,) * (leaf.dim() - 1)).to(leaf.dtype)
        return torch.sum(leaf * w, dim=0)

    return {name: combine(leaf) for name, leaf in stacked.items()}
