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

The importers (a copy of ``frp_tpu/models/params.py:94-644``, numpy only)
bring a site's own weights: ``import_pth_state_dict`` reads a torch state
dict, the minimal protobuf reader (``load_onnx_tensors``,
``load_onnx_graph``) an ONNX export without the ``onnx`` package, and
``import_onnx_graph`` / ``import_onnx_weights`` / ``import_torch_weights``
map the tensors onto an init tree by the order and kind of its units. They
fill a numpy tree in the JAX layouts, which ``convert_params`` then carries
onto the device; the same bytes give the JAX package's tree bit for bit.
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


# ---------------------------------------------------------------------------
# importers: torch state dicts and ONNX exports -> numpy trees (JAX layouts)
# ---------------------------------------------------------------------------

def import_pth_state_dict(path: str) -> dict | None:
    """Load a torch state dict as {name: np.ndarray}, conv weights OIHW->HWIO.

    Returns None when the file is missing/empty/unreadable — mirroring the
    reference's honest handling of its 0-byte checkpoint (deepfake_utils.py:
    91-105): run with initialized weights and report untrained status.
    """
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        return None
    try:
        state = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        return None
    out = {}
    for name, tensor in state.items():
        arr = np.asarray(tensor.detach().cpu().numpy())
        if arr.ndim == 4:  # OIHW -> HWIO
            arr = arr.transpose(2, 3, 1, 0)
        out[name] = arr
    return out


# ---------------------------------------------------------------------------
# torch state-dict -> param-pytree structural mapping
# ---------------------------------------------------------------------------

def _collect_units(tree, path=""):
    """Walk our param tree in deterministic order, yielding typed units:
    ('conv', {'w'}), ('bn', {...}), ('dense', {...}), ('prelu', {...})."""
    units = []
    if isinstance(tree, dict):
        keys = set(tree.keys())
        if keys == {"w"}:
            units.append(("conv", tree, path))
            return units
        if keys == {"gamma", "beta", "mean", "var"}:
            units.append(("bn", tree, path))
            return units
        if keys == {"w", "b"}:
            units.append(("dense", tree, path))
            return units
        if keys == {"alpha"}:
            units.append(("prelu", tree, path))
            return units
        for k in tree:  # insertion order == construction order
            units.extend(_collect_units(tree[k], f"{path}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            units.extend(_collect_units(v, f"{path}{i}/"))
    return units


def _group_torch_modules(state: dict) -> list:
    """Group a torch state dict (insertion order) into typed module units.
    Assumes conv weights arrive as HWIO (import_pth_state_dict transposes)."""
    groups: dict[str, dict] = {}
    order: list[str] = []
    for name, arr in state.items():
        if name.endswith("num_batches_tracked"):
            continue
        prefix, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        if prefix not in groups:
            groups[prefix] = {}
            order.append(prefix)
        groups[prefix][leaf] = np.asarray(arr)
    units = []
    for prefix in order:
        g = groups[prefix]
        if "running_mean" in g:
            units.append(
                ("bn", {"gamma": g["weight"], "beta": g["bias"],
                        "mean": g["running_mean"], "var": g["running_var"]}, prefix)
            )
        elif "weight" in g and g["weight"].ndim == 4:
            unit = {"w": g["weight"]}
            if "bias" in g:
                # keep the bias: silently dropping it shifted every output
                # of biased convs (torch Conv2d default) with no diagnostic
                unit["b"] = g["bias"]
            units.append(("conv", unit, prefix))
        elif "weight" in g and g["weight"].ndim == 2:
            w = g["weight"].T  # torch Linear stores [out, in]
            units.append(("dense", {"w": w, "b": g.get("bias", np.zeros(w.shape[1]))}, prefix))
        elif "weight" in g and g["weight"].ndim == 1 and "bias" not in g:
            units.append(("prelu", {"alpha": g["weight"]}, prefix))
        elif g:
            units.append(("other", g, prefix))
    return units


# ---------------------------------------------------------------------------
# ONNX importer (no onnx/onnxruntime in the image: minimal protobuf reader)
# ---------------------------------------------------------------------------
# The reference's pretrained detector/embedder ship as InsightFace ONNX
# models (``deepfake_utils.py:39-54``). This reads the initializer tensors
# straight out of the ONNX protobuf so real pretrained weights can drop into
# our pytrees when such a file is available.

_ONNX_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _pb_varint(buf: bytes, i: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _pb_fields(buf: bytes):
    """Yield (field_number, wire_type, value) from a protobuf message body.
    Length-delimited values come back as bytes; varints as ints."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _pb_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, i = _pb_varint(buf, i)
        elif wire == 1:  # fixed64
            val, i = buf[i : i + 8], i + 8
        elif wire == 2:  # length-delimited
            ln, i = _pb_varint(buf, i)
            val, i = buf[i : i + ln], i + ln
        elif wire == 5:  # fixed32
            val, i = buf[i : i + 4], i + 4
        else:  # pragma: no cover - groups are long-deprecated
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def _parse_tensorproto(buf: bytes) -> tuple[str, np.ndarray]:
    """TensorProto: 1=dims 2=data_type 4=float_data 5=int32_data 7=int64_data
    8=name 9=raw_data 10=double_data (onnx/onnx.proto3)."""
    dims: list[int] = []
    dtype = np.float32
    name = ""
    raw = None
    typed: list[np.ndarray] = []
    from_int32 = False  # fp16/bf16 non-raw data rides int32_data as bits
    for field, wire, val in _pb_fields(buf):
        if field == 1:
            if wire == 0:
                dims.append(val)
            else:  # packed repeated int64
                i = 0
                while i < len(val):
                    d, i = _pb_varint(val, i)
                    dims.append(d)
        elif field == 2:
            dtype = _ONNX_DTYPES.get(val, np.float32)
        elif field == 8:
            name = val.decode("utf-8", "replace")
        elif field == 9:
            raw = val
        elif field == 4:
            typed.append(np.frombuffer(val, np.float32) if wire == 2
                         else np.frombuffer(bytes(val), np.float32))
        elif field == 5:  # int32_data (packed varints or single)
            if wire == 2:
                vals, i = [], 0
                while i < len(val):
                    v, i = _pb_varint(val, i)
                    vals.append(v)
                typed.append(np.asarray(vals, np.int32))
            else:
                typed.append(np.asarray([val], np.int32))
            from_int32 = True
        elif field == 7:
            if wire == 2:  # packed varints
                vals, i = [], 0
                while i < len(val):
                    v, i = _pb_varint(val, i)
                    vals.append(v)
                typed.append(np.asarray(vals, np.int64))
            else:
                typed.append(np.asarray([val], np.int64))
        elif field == 10:
            typed.append(np.frombuffer(val, np.float64))
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif typed:
        arr = np.concatenate(typed)
        if dtype == np.float16 and from_int32:
            # the ONNX spec stores non-raw float16 values in int32_data as
            # their uint16 bit patterns (onnx.proto3 TensorProto.int32_data
            # comment) — a numeric astype would turn bits into garbage floats
            arr = arr.astype(np.uint16).view(np.float16)
        else:
            arr = arr.astype(dtype)
    else:
        arr = np.zeros(0, dtype)
    return name, arr.reshape(dims) if dims else arr


def load_onnx_tensors(path: str) -> dict | None:
    """Extract {name: np.ndarray} initializers from an ONNX file.

    ModelProto field 7 = graph; GraphProto field 5 = initializer (repeated
    TensorProto). Returns None for missing/empty/undecodable files (same
    honest-absence semantics as import_pth_state_dict)."""
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        return None
    try:
        with open(path, "rb") as f:
            buf = f.read()
        graph = None
        for field, wire, val in _pb_fields(buf):
            if field == 7 and wire == 2:
                graph = val
                break
        if graph is None:
            return None
        out = {}
        for field, wire, val in _pb_fields(graph):
            if field == 5 and wire == 2:
                name, arr = _parse_tensorproto(val)
                out[name] = arr
        return out or None
    except Exception:
        return None


def _parse_attribute(buf: bytes) -> tuple[str, object]:
    """AttributeProto: 1=name 2=f(fixed32) 3=i 4=s 7=floats 8=ints."""
    name = ""
    value: object = None
    floats: list[float] = []
    ints: list[int] = []
    for field, wire, val in _pb_fields(buf):
        if field == 1:
            name = val.decode("utf-8", "replace")
        elif field == 2:
            value = float(np.frombuffer(val, np.float32)[0])
        elif field == 3:
            # varints are unsigned on the wire; attrs like transB are small
            value = val
        elif field == 4:
            value = val
        elif field == 5:
            value = val  # embedded TensorProto bytes (Constant nodes)
        elif field == 7:
            if wire == 2:
                floats.extend(np.frombuffer(val, np.float32).tolist())
            else:
                floats.append(float(np.frombuffer(val, np.float32)[0]))
        elif field == 8:
            if wire == 2:
                i = 0
                while i < len(val):
                    v, i = _pb_varint(val, i)
                    ints.append(v)
            else:
                ints.append(val)
    if floats:
        value = floats
    elif ints:
        value = ints
    return name, value


def _parse_nodeproto(buf: bytes) -> dict:
    """NodeProto: 1=input 2=output 3=name 4=op_type 5=attribute."""
    node = {"op": "", "inputs": [], "outputs": [], "attrs": {}}
    for field, wire, val in _pb_fields(buf):
        if field == 1:
            node["inputs"].append(val.decode("utf-8", "replace"))
        elif field == 2:
            node["outputs"].append(val.decode("utf-8", "replace"))
        elif field == 4:
            node["op"] = val.decode("utf-8", "replace")
        elif field == 5:
            k, v = _parse_attribute(val)
            node["attrs"][k] = v
    return node


def load_onnx_graph(path: str) -> dict | None:
    """Parse an ONNX file into {"initializers": {name: arr}, "nodes": [...]}.

    Real exports (InsightFace det_10g / w600k_r50, torch.onnx + onnxsim) name
    initializers numerically ("onnx::Conv_473", "1234") and serialize them in
    arbitrary order — name-based grouping cannot map them. The node list
    (GraphProto field 1, topologically sorted per the ONNX spec) recovers the
    execution order the structural importer needs. Returns None on
    missing/empty/undecodable files."""
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        return None
    try:
        with open(path, "rb") as f:
            buf = f.read()
        graph = None
        for field, wire, val in _pb_fields(buf):
            if field == 7 and wire == 2:
                graph = val
                break
        if graph is None:
            return None
        inits: dict = {}
        nodes: list = []
        for field, wire, val in _pb_fields(graph):
            if field == 5 and wire == 2:
                name, arr = _parse_tensorproto(val)
                inits[name] = arr
            elif field == 1 and wire == 2:
                nodes.append(_parse_nodeproto(val))
        # Constant nodes act as initializers for their output name
        for node in nodes:
            if node["op"] == "Constant" and node["outputs"]:
                t = node["attrs"].get("value")
                if isinstance(t, bytes):
                    try:
                        _, arr = _parse_tensorproto(t)
                        inits.setdefault(node["outputs"][0], arr)
                    except Exception:
                        pass
        if not inits:
            return None
        return {"initializers": inits, "nodes": nodes}
    except Exception:
        return None


def units_from_onnx_nodes(nodes: list, inits: dict) -> list:
    """Typed weight units in node execution order.

    Understands the ops real face-model exports carry weights in: Conv
    (optionally biased — onnxsim folds BatchNorm into the preceding conv),
    BatchNormalization, PRelu, Gemm (transB-aware), and MatMul+Add pairs.
    Weightless ops (Relu/Add/Concat/Resize/Reshape/...) are skipped.

    Weight-PLUMBING chains are followed: un-constant-folded torch exports
    wrap parameters in shape ops (e.g. PReLU's [C] slope goes through an
    Unsqueeze to [C,1,1] before the PRelu node), so an op input that names
    such a node's output resolves to the underlying initializer. Plumbing
    ops whose input is NOT an initializer are activation-path ops and stay
    skipped."""
    alias: dict = {}

    def resolve(name):
        return inits.get(name, alias.get(name))

    units = []
    pending_matmul: tuple | None = None  # (out_name, w) awaiting its Add bias
    for node in nodes:
        op, ins = node["op"], node["inputs"]
        if op in ("Identity", "Unsqueeze", "Squeeze", "Reshape", "Cast",
                  "Flatten"):
            src = resolve(ins[0]) if ins else None
            if src is not None and node["outputs"]:
                # value-preserving for our purposes: every consumer
                # reshapes/flattens weights to its own layout anyway
                alias[node["outputs"][0]] = np.asarray(src)
            continue
        if pending_matmul is not None:
            out_name, w = pending_matmul
            pending_matmul = None
            if (op == "Add" and len(ins) == 2
                    and out_name in ins
                    and any(resolve(i) is not None
                            for i in ins if i != out_name)):
                bias_name = next(i for i in ins if i != out_name)
                units.append(("dense", {"w": w, "b": np.asarray(
                    resolve(bias_name), np.float32).reshape(-1)},
                    node.get("name", op)))
                continue
            units.append(("dense", {"w": w, "b": np.zeros(w.shape[1], np.float32)},
                          "matmul"))
        if op == "Conv" and len(ins) >= 2 and resolve(ins[1]) is not None:
            w = np.asarray(resolve(ins[1]), np.float32)
            unit = {"w": w.transpose(2, 3, 1, 0)}  # OIHW -> HWIO
            if len(ins) >= 3 and resolve(ins[2]) is not None:
                unit["b"] = np.asarray(resolve(ins[2]), np.float32).reshape(-1)
            units.append(("conv", unit, node.get("name", op)))
        elif op == "BatchNormalization" and len(ins) >= 5:
            units.append(("bn", {
                "gamma": np.asarray(resolve(ins[1]), np.float32),
                "beta": np.asarray(resolve(ins[2]), np.float32),
                "mean": np.asarray(resolve(ins[3]), np.float32),
                "var": np.asarray(resolve(ins[4]), np.float32),
            }, node.get("name", op)))
        elif op == "PRelu" and len(ins) >= 2 and resolve(ins[1]) is not None:
            units.append(("prelu", {
                "alpha": np.asarray(resolve(ins[1]), np.float32).reshape(-1),
            }, node.get("name", op)))
        elif op == "Gemm" and len(ins) >= 2 and resolve(ins[1]) is not None:
            w = np.asarray(resolve(ins[1]), np.float32)
            if node["attrs"].get("transB", 0):  # [out, in] -> [in, out]
                w = w.T
            b = (np.asarray(resolve(ins[2]), np.float32).reshape(-1)
                 if len(ins) >= 3 and resolve(ins[2]) is not None
                 else np.zeros(w.shape[1], np.float32))
            units.append(("dense", {"w": w, "b": b}, node.get("name", op)))
        elif op == "MatMul" and len(ins) == 2 and resolve(ins[1]) is not None:
            w = np.asarray(resolve(ins[1]), np.float32)  # already [in, out]
            pending_matmul = (node["outputs"][0] if node["outputs"] else "", w)
    if pending_matmul is not None:
        out_name, w = pending_matmul
        units.append(("dense", {"w": w, "b": np.zeros(w.shape[1], np.float32)},
                      "matmul"))
    return units


_BN_EPS = 1e-5  # nn.batch_norm's eps: the identity-BN trick depends on it


def import_onnx_graph(params, graph: dict) -> int:
    """Map a parsed ONNX graph onto our param pytree IN PLACE, by node
    execution order — immune to initializer naming and serialization order.

    Tolerates onnxsim-style BatchNorm folding: where the export carries a
    BIASED conv and our tree has a bias-free conv followed by a bn unit, the
    folded weights land in the conv and the bn is neutralized to an exact
    identity-plus-bias (gamma=sqrt(1+eps), beta=bias, mean=0, var=1, so
    x*gamma*rsqrt(var+eps)+beta == x+bias bit-for-practical purposes).
    Imported checkpoints need torch conv-padding semantics: the engine
    switches ``nn.set_padding_mode("torch")`` when it loads only such files
    (``engine/pipeline.py::_load_weights``).
    Raises ValueError on any structural mismatch. Returns tensors copied."""
    theirs = units_from_onnx_nodes(graph["nodes"], graph["initializers"])
    if not theirs:
        raise ValueError("onnx graph carries no recognizable weight units")
    ours = _collect_units(params)
    copied = 0
    i = j = 0

    def _copy(node, values, where):
        nonlocal copied
        for key, arr in values.items():
            if key not in node:
                raise ValueError(f"onnx unit {where} carries '{key}' but our "
                                 f"unit has no such slot")
            if tuple(np.shape(node[key])) != tuple(arr.shape):
                raise ValueError(
                    f"shape mismatch at {where}/{key}: ours "
                    f"{np.shape(node[key])} vs onnx {arr.shape}")
            node[key] = np.asarray(arr, np.float32)
            copied += 1

    while i < len(ours) and j < len(theirs):
        kind_a, node, path = ours[i]
        kind_b, values, name = theirs[j]
        if kind_a == "dense" and kind_b == "conv":
            w = values["w"]
            if w.ndim == 4 and w.shape[0] == w.shape[1] == 1:
                values = dict(values)
                values["w"] = w.reshape(w.shape[2], w.shape[3])
                kind_b = "dense"
        if (kind_a == "conv" and kind_b == "conv" and "b" in values
                and "b" not in node
                and i + 1 < len(ours) and ours[i + 1][0] == "bn"):
            # BN-folded conv: weights here, bias via an identity bn
            _copy(node, {"w": values["w"]}, name)
            bias = values["b"]
            bn = ours[i + 1][1]
            if np.shape(bn["beta"]) != bias.shape:
                raise ValueError(
                    f"folded-conv bias shape {bias.shape} does not match the "
                    f"bn unit at {ours[i + 1][2]} ({np.shape(bn['beta'])})")
            bn["gamma"] = np.full(bias.shape, np.sqrt(1.0 + _BN_EPS), np.float32)
            bn["beta"] = np.asarray(bias, np.float32)
            bn["mean"] = np.zeros(bias.shape, np.float32)
            bn["var"] = np.ones(bias.shape, np.float32)
            copied += 4
            i += 2
            j += 1
            continue
        if kind_a != kind_b:
            raise ValueError(
                f"unit-kind mismatch at ours[{i}]={path} ({kind_a}) vs "
                f"onnx[{j}]={name} ({kind_b})")
        _copy(node, values, name)
        i += 1
        j += 1
    if i < len(ours) or j < len(theirs):
        raise ValueError(
            f"unit-count mismatch: consumed {i}/{len(ours)} of ours, "
            f"{j}/{len(theirs)} of onnx")
    return copied


def import_onnx_weights(params, tensors: dict) -> int:
    """Structurally map ONNX initializer tensors onto our param pytree.

    4-d tensors arrive OIHW (the ONNX conv convention) and are transposed to
    HWIO first; dotted names group into typed modules exactly like a torch
    state dict (torch-exported ONNX keeps them), so the torch mapper is
    reused. Returns tensors copied; raises ValueError on structure mismatch.
    """
    state = {}
    for name, arr in tensors.items():
        arr = np.asarray(arr)
        if arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        state[name] = arr
    return import_torch_weights(params, state)


def import_torch_weights(params, state_dict: dict) -> int:
    """Structurally map a torch state dict onto our param pytree IN PLACE.

    Matching is by (kind, order, shape): the i-th conv/bn/dense/prelu module
    of the torch model maps onto the i-th of ours — valid because both sides
    build the same architecture in the same traversal order (reference
    deepfake checkpoint slot: ``deepfake_utils.py:91-105``). Raises ValueError
    on kind-sequence or shape mismatch. Returns tensors copied.
    """
    ours = _collect_units(params)
    theirs = [u for u in _group_torch_modules(state_dict) if u[0] != "other"]
    if len(ours) != len(theirs):
        raise ValueError(
            f"module-count mismatch: ours {len(ours)} vs torch {len(theirs)}"
        )
    copied = 0
    for (kind_a, node, path), (kind_b, values, prefix) in zip(ours, theirs):
        if kind_a == "dense" and kind_b == "conv":
            w = values["w"]
            # a 1x1 conv on pooled features IS a dense layer (torchvision
            # SqueezeExcitation uses Conv2d where we use dense): coerce
            # HWIO [1, 1, i, o] -> [i, o]
            if w.ndim == 4 and w.shape[0] == w.shape[1] == 1:
                values = dict(values)
                values["w"] = w.reshape(w.shape[2], w.shape[3])
                kind_b = "dense"
        if kind_a != kind_b:
            raise ValueError(
                f"module-kind mismatch at {path} ({kind_a}) vs {prefix} ({kind_b})"
            )
        for key, arr in values.items():
            if key not in node:
                raise ValueError(
                    f"torch module {prefix} carries '{key}' but our unit "
                    f"{path} has no such slot (e.g. a biased conv mapping "
                    f"onto a bias-free conv+bn unit)"
                )
            if tuple(np.shape(node[key])) != tuple(arr.shape):
                raise ValueError(
                    f"shape mismatch at {path}{key}: ours {np.shape(node[key])} "
                    f"vs torch {prefix} {arr.shape}"
                )
            node[key] = np.asarray(arr, np.float32)
            copied += 1
    return copied
