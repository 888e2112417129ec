"""Plain float32 forwards of the four networks the recognition pipeline
serves, written from their published descriptions and the layouts of the
shipped ``weights/*.npz`` files (conv weights HWIO, dense weights
[in, out], batch norm as gamma, beta, running mean and variance):

* RetinaFace with a MobileNetV1-0.25 backbone (arXiv:1905.00641, the
  ``cfg_mnet`` widths 8-256, FPN and SSH at 64 channels, 2 anchors a cell);
* MobileFaceNet (arXiv:1804.07573), PReLU, a 7x7 global depthwise conv;
* ArcFace's improved ResNet (arXiv:1801.07698), iresnet18/34/50/100;
* MobileNetV3-Small (arXiv:1905.02244) with a two-class head.

Convolutions pad as XLA's ``SAME`` (a stride-2 conv on an even input pads
(0, 1)), the convention the shipped weights were trained under. Batch norm
is the inference form. Every conv and dense input, and its weight, passes
through ``q``: the identity for the reference, a per-tensor fp8 rounding
for the control (``perfbench/reference/precision.py``).

Nothing here imports the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-5


def _ident(x):
    return x


def _same(n: int, k: int, s: int) -> tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(w, x, stride=1, groups=1, valid=False, q=_ident):
    """x NCHW, w HWIO [kh, kw, cin/groups, cout]."""
    wt = q(w.permute(3, 2, 0, 1))
    if not valid:
        ph = _same(x.shape[2], wt.shape[2], stride)
        pw = _same(x.shape[3], wt.shape[3], stride)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(q(x), wt, None, stride, 0, 1, groups)


def bn(p, x):
    scale = p["gamma"] / torch.sqrt(p["var"] + EPS)
    shift = p["beta"] - p["mean"] * scale
    shape = (1, -1, 1, 1) if x.dim() == 4 else (1, -1)
    return x * scale.reshape(shape) + shift.reshape(shape)


def dense(p, x, q=_ident):
    return q(x) @ q(p["w"]) + p["b"]


def prelu(alpha, x):
    return torch.where(x >= 0, x, alpha.reshape(1, -1, 1, 1) * x)


def leaky(x):
    return torch.where(x >= 0, x, 0.1 * x)


def relu(x):
    return torch.clamp(x, min=0.0)


def hsigmoid(x):
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hswish(x):
    return x * hsigmoid(x)


def l2n(x):
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=1e-12))


# -- RetinaFace, MobileNetV1-0.25 ---------------------------------------------

_MNET = ([(16, 1), (32, 2), (32, 1), (64, 2), (64, 1)],
         [(128, 2)] + [(128, 1)] * 5,
         [(256, 2), (256, 1)])
ANCHORS_PER_CELL = 2


def _cbl(p, x, stride=1, groups=1, q=_ident):
    """conv, BN, then the block's PReLU where it has one, else leaky 0.1."""
    y = bn(p["bn"], conv(p["conv"]["w"], x, stride, groups, q=q))
    return prelu(p["act"]["alpha"], y) if "act" in p else leaky(y)


def _cb(p, x, q=_ident):
    return bn(p["bn"], conv(p["conv"]["w"], x, q=q))


def retinaface(p, x, q=_ident):
    """x [B, S, S, 3] normalised frames -> (loc [B, A, 4], ldm [B, A, 10],
    score [B, A]); A runs over strides 8, 16, 32, then rows, columns and the
    two anchors of a cell."""
    y = _cbl(p["stem"], x.permute(0, 3, 1, 2), stride=2, q=q)
    feats = []
    for name, plan in zip(("stage1", "stage2", "stage3"), _MNET):
        for blk, (_, s) in zip(p[name], plan):
            y = _cbl(blk["dw"], y, s, groups=y.shape[1], q=q)
            y = _cbl(blk["pw"], y, q=q)
        feats.append(y)
    lat = [_cbl(pp, f, q=q) for pp, f in zip(p["fpn_lat"], feats)]

    def up(t, like):
        return F.interpolate(t, size=like.shape[2:], mode="nearest-exact")

    p2 = _cbl(p["fpn_td"][0], lat[1] + up(lat[2], lat[1]), q=q)
    p1 = _cbl(p["fpn_td"][1], lat[0] + up(p2, lat[0]), q=q)
    outs = []
    for sp, f in zip(p["ssh"], (p1, p2, lat[2])):
        c3 = _cb(sp["conv3"], f, q)
        c51 = _cbl(sp["conv5_1"], f, q=q)
        c5 = _cb(sp["conv5_2"], c51, q)
        c72 = _cbl(sp["conv7_2"], c51, q=q)
        c7 = _cb(sp["conv7_3"], c72, q)
        outs.append(relu(torch.cat([c3, c5, c7], 1)))

    def head(convs, dims):
        parts = []
        for cp, f in zip(convs, outs):
            y = conv(cp["w"], f, q=q)
            parts.append(y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, dims))
        return torch.cat(parts, 1)

    cls = head(p["head_cls"], 2)
    score = torch.softmax(cls, -1)[..., 1]
    return head(p["head_box"], 4), head(p["head_ldm"], 10), score


# -- MobileFaceNet ------------------------------------------------------------

_MFN = [(2, 64, 5, 2), (4, 128, 1, 2), (2, 128, 6, 1), (4, 128, 1, 2), (2, 128, 2, 1)]


def mobilefacenet(p, x, q=_ident):
    """x [B, 112, 112, 3] normalised crops -> [B, D] unit embeddings."""
    y = bn(p["stem"]["bn"], conv(p["stem"]["conv"]["w"], x.permute(0, 3, 1, 2), 2, q=q))
    y = prelu(p["stem_prelu"]["alpha"], y)
    y = prelu(p["dw1_prelu"]["alpha"],
              bn(p["dw1"]["bn"], conv(p["dw1"]["conv"]["w"], y, groups=64, q=q)))
    i, cin = 0, 64
    for _, c, n, s in _MFN:
        for j in range(n):
            b = p["blocks"][i]
            stride = s if j == 0 else 1
            h = prelu(b["expand_prelu"]["alpha"], _cb(b["expand"], y, q))
            h = conv(b["dw"]["conv"]["w"], h, stride, groups=h.shape[1], q=q)
            h = prelu(b["dw_prelu"]["alpha"], bn(b["dw"]["bn"], h))
            h = _cb(b["project"], h, q)
            y = y + h if (stride == 1 and cin == c) else h
            cin = c
            i += 1
    y = prelu(p["head_prelu"]["alpha"], _cb(p["conv_head"], y, q))
    y = bn(p["gdconv"]["bn"], conv(p["gdconv"]["conv"]["w"], y, groups=512, valid=True, q=q))
    y = _cb(p["embed"], y, q)
    return l2n(y.reshape(y.shape[0], -1))


# -- iresnet ------------------------------------------------------------------

IRESNET_DEPTHS = {"iresnet18": (2, 2, 2, 2), "iresnet34": (3, 4, 6, 3),
                  "iresnet50": (3, 4, 14, 3), "iresnet100": (3, 13, 30, 3)}


def iresnet(p, x, q=_ident):
    """x [B, 112, 112, 3] normalised crops -> [B, D] unit embeddings. A block
    is BN, conv3x3, BN, PReLU, conv3x3 with the stride, BN, plus the
    shortcut (1x1 conv and BN with the stride where the shape changes)."""
    y = conv(p["stem"]["w"], x.permute(0, 3, 1, 2), q=q)
    y = prelu(p["stem_prelu"]["alpha"], bn(p["stem_bn"], y))
    for stage in p["stages"]:
        for bi, b in enumerate(stage):
            s = 2 if bi == 0 else 1
            h = conv(b["conv1"]["w"], bn(b["bn1"], y), q=q)
            h = prelu(b["prelu"]["alpha"], bn(b["bn2"], h))
            h = bn(b["bn3"], conv(b["conv2"]["w"], h, s, q=q))
            sc = y
            if "down_conv" in b:
                sc = bn(b["down_bn"], conv(b["down_conv"]["w"], y, s, q=q))
            y = sc + h
    y = bn(p["head_bn"], y)
    emb = bn(p["feat_bn"], dense(p["fc"], y.reshape(y.shape[0], -1), q))
    return l2n(emb)


# -- MobileNetV3-Small --------------------------------------------------------

# (kernel, expanded, out, squeeze-excite, hard-swish, stride)
_MNV3 = [(3, 16, 16, True, False, 2), (3, 72, 24, False, False, 2),
         (3, 88, 24, False, False, 1), (5, 96, 40, True, True, 2),
         (5, 240, 40, True, True, 1), (5, 240, 40, True, True, 1),
         (5, 120, 48, True, True, 1), (5, 144, 48, True, True, 1),
         (5, 288, 96, True, True, 2), (5, 576, 96, True, True, 1),
         (5, 576, 96, True, True, 1)]


def mobilenetv3(p, x, q=_ident):
    """x [B, S, S, 3] ImageNet-normalised crops -> [B, classes] logits."""
    y = hswish(bn(p["stem"]["bn"], conv(p["stem"]["conv"]["w"], x.permute(0, 3, 1, 2), 2, q=q)))
    cin = 16
    for b, (_, _, cout, se, hs, s) in zip(p["blocks"], _MNV3):
        act = hswish if hs else relu
        inp = y
        if b.get("expand") is not None:
            y = act(_cb(b["expand"], y, q))
        y = act(bn(b["dw"]["bn"], conv(b["dw"]["conv"]["w"], y, s, groups=y.shape[1], q=q)))
        if se:
            z = y.mean((2, 3))
            z = relu(dense(b["se"]["fc1"], z, q))
            z = hsigmoid(dense(b["se"]["fc2"], z, q))
            y = y * z[:, :, None, None]
        y = _cb(b["project"], y, q)
        if s == 1 and cin == cout:
            y = inp + y
        cin = cout
    y = hswish(_cb(p["last_conv"], y, q)).mean((2, 3))
    y = hswish(dense(p["fc1"], y, q))
    return dense(p["fc2"], y, q)


EMBEDDERS = {"mobilefacenet": mobilefacenet, **{k: iresnet for k in IRESNET_DEPTHS}}
