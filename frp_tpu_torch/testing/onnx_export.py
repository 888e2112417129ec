"""ONNX bytes written from parameter trees, without the ``onnx`` package.

Test and smoke support, as ``testing/synthetic.py``: a site's real exports
(InsightFace's ``w600k_r50.onnx``, a RetinaFace-family ``det_*.onnx``, a
torchvision MobileNetV3-Small) are not in the repository, so the import path
is driven with byte-level replicas built here from seeded or shipped numpy
trees (the JAX layouts). They carry what breaks a name-based walk in real
exports: numeric initializer names ("onnx::Conv_473", "1234") serialized in a
shuffled order, BatchNorms folded into biased convs as onnxsim leaves them,
float16 initializers in both encodings the spec allows (raw bytes, and bit
patterns in ``int32_data``), int64 shape initializers, weightless plumbing
nodes (Flatten, Reshape, Resize with roi/scales initializers, Concat,
activations), and nodes in execution order. Every conv pads k//2 on both
sides, as torch exports do, so such weights are served under
``nn.set_padding_mode("torch")``.

    iresnet_graph(params, folded=True, shuffle_rng=..., fp16_rng=...)
    retinaface_graph(params, shuffle_rng=..., fp16_rng=...)
    mobilenetv3_graph(params, shuffle_rng=..., fp16_rng=...)

The writer mirrors the reader of ``models/params.py`` field for field (the
JAX package's test-side writer is ``tests/test_onnx_real_export.py:37-320``).
"""

from __future__ import annotations

import struct

import numpy as np

EPS = 1e-5  # ONNX BatchNormalization's default epsilon, nn.batch_norm's eps

# --- protobuf writers ---------------------------------------------------------


def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _fld(num: int, wire: int, payload) -> bytes:
    key = _varint((num << 3) | wire)
    if wire == 0:
        return key + _varint(payload)
    if wire == 5:
        return key + payload  # fixed32: the payload is already 4 bytes
    return key + _varint(len(payload)) + payload


def _varints_u16(bits: np.ndarray) -> bytes:
    """Packed varints of uint16 values (1 to 3 bytes each), with numpy."""
    v = bits.astype(np.uint32)
    n = 1 + (v >= 1 << 7) + (v >= 1 << 14)
    out = np.zeros((len(v), 3), np.uint8)
    for k in range(3):
        more = n > k + 1
        out[:, k] = ((v >> (7 * k)) & 0x7F) | np.where(more, 0x80, 0)
    return out[np.arange(3)[None, :] < n[:, None]].tobytes()


def tensor_proto(name: str, arr: np.ndarray, int32_style: bool = False) -> bytes:
    """TensorProto: dims, data_type, name, and raw_data (or, with
    ``int32_style``, a float16 tensor's bit patterns as packed varints in
    int32_data, the spec's non-raw float16 encoding)."""
    arr = np.ascontiguousarray(arr)
    dt = {np.dtype(np.float32): 1, np.dtype(np.int64): 7, np.dtype(np.float16): 10}[arr.dtype]
    body = b"".join(_fld(1, 0, d) for d in arr.shape)
    body += _fld(2, 0, dt)
    body += _fld(8, 2, name.encode())
    if int32_style:
        if arr.dtype != np.float16:
            raise ValueError("int32_data bit patterns are float16's encoding")
        body += _fld(5, 2, _varints_u16(arr.reshape(-1).view(np.uint16)))
    else:
        body += _fld(9, 2, arr.tobytes())
    return body


def _attr_i(name: str, v: int) -> bytes:
    return _fld(1, 2, name.encode()) + _fld(3, 0, v)


def _attr_f(name: str, v: float) -> bytes:
    return _fld(1, 2, name.encode()) + _fld(2, 5, struct.pack("<f", v))


def _attr_ints(name: str, vals) -> bytes:
    return _fld(1, 2, name.encode()) + b"".join(_fld(8, 0, v) for v in vals)


def _attr_s(name: str, v: bytes) -> bytes:
    return _fld(1, 2, name.encode()) + _fld(4, 2, v)


def _node(op: str, inputs, outputs, *attrs) -> bytes:
    body = b"".join(_fld(1, 2, i.encode()) for i in inputs)
    body += b"".join(_fld(2, 2, o.encode()) for o in outputs)
    body += _fld(4, 2, op.encode())
    body += b"".join(_fld(5, 2, a) for a in attrs)
    return body


def model_bytes(nodes: list, initializers: dict, shuffle_rng=None, fp16_rng=None) -> bytes:
    """ModelProto (ir_version 9, graph = nodes + initializers).
    ``shuffle_rng`` serializes the initializers in a shuffled order;
    ``fp16_rng`` stores about half of the float32 ones as float16, half of
    those as int32_data bit patterns. The stored values are then the
    float16-rounded ones, which every reader sees."""
    names = list(initializers)
    if shuffle_rng is not None:
        shuffle_rng.shuffle(names)
    parts = [_fld(1, 2, n) for n in nodes]
    for n in names:
        arr = initializers[n]
        int32_style = False
        if (fp16_rng is not None and arr.dtype == np.float32 and arr.size > 0
                and fp16_rng.random() < 0.5):
            arr = arr.astype(np.float16)
            int32_style = bool(fp16_rng.random() < 0.5)
        parts.append(_fld(5, 2, tensor_proto(n, arr, int32_style)))
    return _fld(1, 0, 9) + _fld(7, 2, b"".join(parts))


# --- graph emitter --------------------------------------------------------------


class Emit:
    """Collects nodes and numerically named initializers of one graph."""

    def __init__(self):
        self.nodes: list[bytes] = []
        self.inits: dict[str, np.ndarray] = {}
        self._n = 400  # numeric names, as constant-folded exports have

    def name(self, tag: str = "") -> str:
        self._n += 1
        return f"onnx::{tag}_{self._n}" if tag else str(self._n)

    def init(self, arr: np.ndarray, tag: str = "") -> str:
        n = self.name(tag)
        self.inits[n] = arr
        return n

    def op(self, op: str, inputs, *attrs) -> str:
        """A weightless node (its inputs named already)."""
        out = self.name(op)
        self.nodes.append(_node(op, list(inputs), [out], *attrs))
        return out

    # Nodes with initializers name their output before their initializers,
    # as the JAX package's test writer does, so the two give the same bytes.

    def conv(self, x: str, w_hwio, b=None, stride: int = 1, groups: int = 1) -> str:
        kh, kw = np.shape(w_hwio)[:2]
        out = self.name("Conv")
        ins = [x, self.init(np.ascontiguousarray(
            np.asarray(w_hwio, np.float32).transpose(3, 2, 0, 1)), "Conv")]
        if b is not None:
            ins.append(self.init(np.asarray(b, np.float32), "Conv"))
        self.nodes.append(_node(
            "Conv", ins, [out], _attr_ints("kernel_shape", [kh, kw]),
            _attr_ints("strides", [stride, stride]),
            _attr_ints("pads", [kh // 2, kw // 2, kh // 2, kw // 2]), _attr_i("group", groups)))
        return out

    def bn(self, x: str, p: dict) -> str:
        out = self.name("Bn")
        ins = [x] + [self.init(np.asarray(p[k], np.float32)) for k in ("gamma", "beta", "mean", "var")]
        self.nodes.append(_node("BatchNormalization", ins, [out], _attr_f("epsilon", EPS)))
        return out

    def folded_conv(self, x: str, conv_p: dict, bn_p: dict, stride: int = 1,
                    groups: int = 1) -> str:
        """onnxsim's conv + BN fusion: one biased Conv node."""
        scale = np.asarray(bn_p["gamma"], np.float64) / np.sqrt(
            np.asarray(bn_p["var"], np.float64) + EPS)
        w = np.asarray(conv_p["w"], np.float64) * scale[None, None, None, :]
        b = np.asarray(bn_p["beta"], np.float64) - np.asarray(bn_p["mean"], np.float64) * scale
        return self.conv(x, w.astype(np.float32), b.astype(np.float32), stride, groups)

    def prelu(self, x: str, alpha) -> str:
        out = self.name("PRelu")
        slope = np.asarray(alpha, np.float32).reshape(-1, 1, 1)  # [C, 1, 1]
        self.nodes.append(_node("PRelu", [x, self.init(slope)], [out]))
        return out

    def leaky_relu(self, x: str, alpha: float = 0.1) -> str:
        return self.op("LeakyRelu", [x], _attr_f("alpha", alpha))

    def gemm(self, x: str, w_io, b) -> str:
        out = self.name("Gemm")
        w_oi = np.ascontiguousarray(np.asarray(w_io, np.float32).T)  # transB
        self.nodes.append(_node(
            "Gemm", [x, self.init(w_oi), self.init(np.asarray(b, np.float32))], [out],
            _attr_i("transB", 1), _attr_f("alpha", 1.0), _attr_f("beta", 1.0)))
        return out

    def reshape_flat(self, x: str) -> str:
        out = self.name("Reshape")
        shape = self.init(np.asarray([0, -1], np.int64), "Shape")
        self.nodes.append(_node("Reshape", [x, shape], [out]))
        return out

    def resize2x(self, x: str) -> str:
        """torch.onnx's nearest upsample: roi and scales as initializers,
        the modes as string attributes."""
        out = self.name("Resize")
        roi = self.init(np.zeros(0, np.float32), "Roi")
        scales = self.init(np.asarray([1.0, 1.0, 2.0, 2.0], np.float32), "Scales")
        self.nodes.append(_node(
            "Resize", [x, roi, scales], [out], _attr_s("mode", b"nearest"),
            _attr_s("coordinate_transformation_mode", b"asymmetric"),
            _attr_s("nearest_mode", b"floor")))
        return out


# --- the three model families ----------------------------------------------------


def iresnet_graph(params: dict, folded: bool = True, shuffle_rng=None, fp16_rng=None) -> bytes:
    """A w600k_r50-style export of an iresnet tree (``models/iresnet.py``),
    in execution order: with ``folded``, each conv followed by a BN is one
    biased Conv, and the flatten is a Flatten node; else Conv and
    BatchNormalization nodes, and a Reshape by an int64 shape initializer."""
    e = Emit()

    def conv_bn(x, conv_p, bn_p, stride=1):
        if folded:
            return e.folded_conv(x, conv_p, bn_p, stride)
        return e.bn(e.conv(x, conv_p["w"], stride=stride), bn_p)

    t = e.prelu(conv_bn("input", params["stem"], params["stem_bn"]), params["stem_prelu"]["alpha"])
    for stage in params["stages"]:
        for bi, blk in enumerate(stage):
            stride = 2 if bi == 0 else 1
            y = conv_bn(e.bn(t, blk["bn1"]), blk["conv1"], blk["bn2"])
            y = e.prelu(y, blk["prelu"]["alpha"])
            y = conv_bn(y, blk["conv2"], blk["bn3"], stride)
            s = conv_bn(t, blk["down_conv"], blk["down_bn"], stride) if "down_conv" in blk else t
            t = e.op("Add", [s, y])
    t = e.bn(t, params["head_bn"])
    t = e.op("Flatten", [t], _attr_i("axis", 1)) if folded else e.reshape_flat(t)
    t = e.gemm(t, params["fc"]["w"], params["fc"]["b"])
    e.bn(t, params["feat_bn"])
    return model_bytes(e.nodes, e.inits, shuffle_rng, fp16_rng)


def retinaface_graph(params: dict, shuffle_rng=None, fp16_rng=None) -> bytes:
    """A det-style export of a RetinaFace tree (``models/retinaface.py``) in
    true execution order (the FPN's p2 merge before p1's), BN folded; each
    activated block ends in a PRelu with [C, 1, 1] slopes where the tree
    holds them (act="prelu", the real det exports' shape), else in a
    LeakyRelu 0.1; upsamples are Resize nodes, the SSH joins a Concat and a
    Relu, and the heads are plain unbiased 1x1 convs."""
    from frp_tpu_torch.models.retinaface import _STAGE1, _STAGE2, _STAGE3

    e = Emit()

    def cb(x, p, stride=1, groups=1, act=True):
        y = e.folded_conv(x, p["conv"], p["bn"], stride, groups)
        if not act:
            return y
        return e.prelu(y, p["act"]["alpha"]) if "act" in p else e.leaky_relu(y)

    t = cb("input", params["stem"], stride=2)
    feats = []
    for name, plan in (("stage1", _STAGE1), ("stage2", _STAGE2), ("stage3", _STAGE3)):
        for p, (_, stride) in zip(params[name], plan):
            t = cb(t, p["dw"], stride, groups=np.shape(p["dw"]["conv"]["w"])[3])
            t = cb(t, p["pw"])
        feats.append(t)
    lat = [cb(f, p) for p, f in zip(params["fpn_lat"], feats)]
    p2 = cb(e.op("Add", [lat[1], e.resize2x(lat[2])]), params["fpn_td"][0])
    p1 = cb(e.op("Add", [lat[0], e.resize2x(p2)]), params["fpn_td"][1])
    feats = []
    for p, f in zip(params["ssh"], [p1, p2, lat[2]]):
        c3 = cb(f, p["conv3"], act=False)
        c5_1 = cb(f, p["conv5_1"])
        c5 = cb(c5_1, p["conv5_2"], act=False)
        c7 = cb(cb(c5_1, p["conv7_2"]), p["conv7_3"], act=False)
        cat = e.op("Concat", [c3, c5, c7], _attr_i("axis", 1))
        feats.append(e.op("Relu", [cat]))
    for head in ("head_cls", "head_box", "head_ldm"):
        for p, f in zip(params[head], feats):
            e.conv(f, p["w"])
    return model_bytes(e.nodes, e.inits, shuffle_rng, fp16_rng)


def mobilenetv3_graph(params: dict, shuffle_rng=None, fp16_rng=None) -> bytes:
    """A torchvision-style export of the MobileNetV3-Small tree
    (``models/mobilenetv3.py``), BN folded: the squeeze-excitation's two
    layers are biased 1x1 Convs on a GlobalAveragePool (torchvision's
    SqueezeExcitation), which the importer lays onto the tree's dense units;
    the classifier is two Gemms."""
    from frp_tpu_torch.models.mobilenetv3 import _SPEC

    e = Emit()

    def act(x, hs):
        return e.op("HardSwish" if hs else "Relu", [x])

    t = act(e.folded_conv("input", params["stem"]["conv"], params["stem"]["bn"], 2), True)
    cin = 16
    for p, (k, exp, cout, use_se, use_hs, stride) in zip(params["blocks"], _SPEC):
        inp = t
        if p["expand"] is not None:
            t = act(e.folded_conv(t, p["expand"]["conv"], p["expand"]["bn"]), use_hs)
        t = act(e.folded_conv(t, p["dw"]["conv"], p["dw"]["bn"], stride, groups=exp), use_hs)
        if use_se:
            s = e.op("GlobalAveragePool", [t])
            s = e.op("Relu", [e.conv(s, np.asarray(p["se"]["fc1"]["w"])[None, None],
                                     p["se"]["fc1"]["b"])])
            s = e.op("HardSigmoid", [e.conv(s, np.asarray(p["se"]["fc2"]["w"])[None, None],
                                            p["se"]["fc2"]["b"])],
                     _attr_f("alpha", 1.0 / 6.0), _attr_f("beta", 0.5))
            t = e.op("Mul", [t, s])
        t = e.folded_conv(t, p["project"]["conv"], p["project"]["bn"])
        if stride == 1 and cin == cout:
            t = e.op("Add", [inp, t])
        cin = cout
    t = act(e.folded_conv(t, params["last_conv"]["conv"], params["last_conv"]["bn"]), True)
    t = e.op("Flatten", [e.op("GlobalAveragePool", [t])], _attr_i("axis", 1))
    t = act(e.gemm(t, params["fc1"]["w"], params["fc1"]["b"]), True)
    e.gemm(t, params["fc2"]["w"], params["fc2"]["b"])
    return model_bytes(e.nodes, e.inits, shuffle_rng, fp16_rng)


def realistic_stats(params, rng, gamma=(0.1, 0.3), slopes=(0.05, 0.45)):
    """Give a seeded init tree trained-looking BN statistics (non-zero means,
    non-unit variances, small gammas, which keep a deep residual net's
    activations bounded) and PReLU slopes, in place, so that a dropped or
    misplaced tensor shows in a forward. Returns the tree."""
    from frp_tpu_torch.models.params import _collect_units

    for kind, node, _ in _collect_units(params):
        if kind == "bn":
            node["gamma"] = rng.uniform(*gamma, node["gamma"].shape).astype(np.float32)
            node["mean"] = rng.normal(0, 0.3, node["mean"].shape).astype(np.float32)
            node["var"] = (0.5 + rng.random(node["var"].shape)).astype(np.float32)
        elif kind == "prelu":
            node["alpha"] = rng.uniform(*slopes, node["alpha"].shape).astype(np.float32)
    return params


def w600k_style(seed: int = 12, variant: str = "iresnet50", embed_dim: int = 512,
                fp16: bool = True) -> bytes:
    """The bytes of a seeded w600k_r50-style ``embedder.onnx``: iresnet50,
    512-d, trained-looking statistics, BN folded, numeric names in a
    shuffled order; with ``fp16``, about half the initializers float16."""
    from frp_tpu_torch.models.iresnet import init_iresnet

    params = realistic_stats(init_iresnet(seed, variant=variant, embed_dim=embed_dim),
                             np.random.default_rng(seed))
    return iresnet_graph(params, folded=True, shuffle_rng=np.random.default_rng(seed + 1),
                         fp16_rng=np.random.default_rng(seed + 2) if fp16 else None)
