"""Parameter files without JAX (port of the ``.npz`` half of
``frp_tpu/models/params.py``).

``load_params`` reads the flat ``a/b/0/w`` keys that the JAX package's
``save_params`` writes (a ``#none`` suffix marks a ``None`` leaf, e.g.
MobileNetV3's absent ``expand`` conv) into the same nested dict/list tree of
numpy arrays, and ``save_params`` writes such a file. ``convert_params``
carries a numpy tree onto a device in the port's layouts: conv weights HWIO
-> OIHW, dense weights [in, out] -> [out, in] (``F.linear``), everything
else (BN stats, PReLU slopes, biases, a bare classifier matrix) as it is;
``to_numpy_params`` is the way back. So weights cross both ways: a file the
port writes loads into the JAX engine's ``load_params`` unchanged, and the
reverse.
"""

from __future__ import annotations

import os
from typing import Callable

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


def save_params(path: str, params) -> None:
    """Write a parameter tree as the JAX package's ``save_params`` does
    (``frp_tpu/models/params.py:62-72``): flat ``a/b/0/w`` keys, ``#none``
    for a ``None`` leaf, to a temporary file that then replaces ``path``.
    ``params`` is a numpy tree in the JAX layouts, or a tensor tree in the
    port's (``convert_params``' output), which is carried back first."""
    if any(isinstance(v, torch.Tensor) for v in flatten_params(params).values()):
        params = to_numpy_params(params)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                if not k.startswith("_"):
                    walk(v, f"{prefix}{k}/")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}/")
        elif node is None:
            flat[prefix[:-1] + "#none"] = np.zeros(0, np.float32)
        else:
            flat[prefix[:-1]] = np.asarray(node)

    walk(params, "")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # a file handle: savez appends no .npz
        np.savez(f, **flat)
    os.replace(tmp, path)


def count_params(params) -> int:
    """Number of scalars in a tree's array leaves."""
    return int(sum(int(np.prod(np.shape(v))) for v in flatten_params(params).values()))


def deterministic_params(init_fn: Callable, seed: int = 0, **kwargs):
    """Seeded init: the same weights on every host, no downloads."""
    return init_fn(seed, **kwargs)


def flatten_params(tree, prefix: str = "") -> dict:
    """{"a/b/0/w": array} for every array leaf (``None`` leaves skipped, as
    a pytree flatten skips them, and so are the layers' ``_cast`` and
    ``_folded`` caches)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if isinstance(k, str) and k.startswith("_"):
                continue
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


def to_numpy_params(tree):
    """Tensor tree in the port's layouts -> numpy tree in the JAX layouts
    (the inverse of ``convert_params``): conv weights OIHW -> HWIO, dense
    weights [out, in] -> [in, out], the rest as it is. The layers' caches
    are left out."""
    if isinstance(tree, dict):
        out = {k: to_numpy_params(v) for k, v in tree.items() if not k.startswith("_")}
        w = out.get("w")
        if w is not None and w.ndim == 4:  # conv OIHW -> HWIO
            out["w"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
        elif w is not None and w.ndim == 2:  # dense [out, in] -> [in, out]
            out["w"] = np.ascontiguousarray(w.T)
        return out
    if isinstance(tree, (list, tuple)):
        return [to_numpy_params(v) for v in tree]
    if tree is None:
        return None
    return tree.detach().to("cpu", torch.float32).numpy().copy()
