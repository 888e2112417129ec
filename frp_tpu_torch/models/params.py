"""Parameter files without JAX (port of the ``.npz`` half of
``frp_tpu/models/params.py``).

``load_params`` reads the flat ``a/b/0/w`` keys that the JAX package's
``save_params`` writes (a ``#none`` suffix marks a ``None`` leaf, e.g.
MobileNetV3's absent ``expand`` conv) into the same nested dict/list tree of
numpy arrays. ``convert_params`` carries such a tree onto a device in the
port's layouts: conv weights HWIO -> OIHW, dense weights [in, out] ->
[out, in] (``F.linear``), everything else (BN stats, PReLU slopes, biases)
as it is.
"""

from __future__ import annotations

import numpy as np
import torch


def _unflatten(flat: dict):
    root: dict = {}
    for key, val in flat.items():
        is_none = key.endswith("#none")
        if is_none:
            key = key[: -len("#none")]
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = None if is_none else val
    return _listify(root)


def _listify(node):
    if not isinstance(node, dict):
        return node
    keys = list(node.keys())
    if keys and all(k.isdigit() for k in keys):
        return [_listify(node[str(i)]) for i in range(len(keys))]
    return {k: _listify(v) for k, v in node.items()}


def load_params(path: str):
    """npz written by ``save_params`` -> nested dict/list tree of numpy."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return _unflatten(flat)


def flatten_params(tree, prefix: str = "") -> dict:
    """{"a/b/0/w": array} for every array leaf (``None`` leaves skipped, as
    a pytree flatten skips them)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_params(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_params(v, f"{prefix}{i}/"))
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def same_structure(ref, got) -> bool:
    """Key paths AND shapes equal (two shape-identical subtrees under
    different names must not load crossed)."""
    a, b = flatten_params(ref), flatten_params(got)
    return a.keys() == b.keys() and all(
        np.shape(a[k]) == np.shape(b[k]) for k in a)


def convert_params(tree, device="cpu"):
    """Numpy parameter tree (JAX layouts) -> tree of f32 tensors on
    ``device`` in the port's layouts."""
    if isinstance(tree, dict):
        out = {k: convert_params(v, device) for k, v in tree.items()}
        w = out.get("w")
        if w is not None and w.dim() == 4:  # conv HWIO -> OIHW
            out["w"] = w.permute(3, 2, 0, 1).contiguous()
        elif w is not None and w.dim() == 2:  # dense [in, out] -> [out, in]
            out["w"] = w.T.contiguous()
        return out
    if isinstance(tree, (list, tuple)):
        return [convert_params(v, device) for v in tree]
    if tree is None:
        return None
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)
