"""ArcFace training for the embedders on one card (port of
``frp_tpu/train/arcface.py``).

The step: uint8 or [-1, 1] float crops -> the backbone's training forward
(batch-statistics BN) -> L2-normalised embeddings -> margined, scaled cosine
logits against the L2-normalised classifier -> softmax cross-entropy; then
SGD with momentum 0.9 and weight decay on every leaf (optax's
``chain(add_decayed_weights(wd), sgd(lr, momentum=0.9))``, which is
``torch.optim.SGD(lr, momentum=0.9, weight_decay=wd)`` over one group holding
every leaf: BN gamma, beta, mean and var, PReLU slopes and the classifier
too); then the BN running stats of the forward overwrite ``mean`` and
``var``, whatever the optimizer did to them.

Parameters are the port's tensor trees (``models/params.convert_params``)
with every leaf a master in f32 that requires grad; convs cast their weights
to the activation's dtype (bf16 by default). The seeded initial state equals
the JAX package's: the backbone's own init, the classifier drawn from
``default_rng(seed)``, optimizer buffers at zero.

Not ported: the (data, model) mesh. ``mesh=`` raises (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from frp_tpu_torch.engine.pipeline import resolve_device
from frp_tpu_torch.models import nn
from frp_tpu_torch.models.mobilefacenet import init_mobilefacenet, mobilefacenet_forward
from frp_tpu_torch.models.params import convert_params, flatten_params, to_numpy_params

def no_mesh(mesh, what: str) -> None:
    """The trainers run on one card: a mesh is refused, never ignored."""
    if mesh is not None:
        raise NotImplementedError(
            f"{what} over a device mesh is not ported yet (ROADMAP, Queue 1 item 5)")


def arcface_logits(
    emb: torch.Tensor,
    w: torch.Tensor,
    labels: torch.Tensor,
    margin: float = 0.5,
    scale: float = 64.0,
    num_real_classes: int | None = None,
) -> torch.Tensor:
    """emb [B, D] (normalized), w [D, C] -> margined, scaled logits [B, C] in
    f32 (``frp_tpu/train/arcface.py:38-72``).

    The cosine is clipped to +-(1 - 1e-7) before the arccos, with JAX's clip
    rule (``nn._clip``: a tie with a bound splits the gradient in half, where
    ``torch.clamp`` would pass it whole). A tie takes a cosine of exactly
    1 - 1e-7 in f32, an embedding equal to its normalised class column, which
    no test and no random init reaches; the rule is kept all the same, so
    the two steps could not part there. Past theta = pi - m the target
    falls back to cos - m sin m (the easy-margin guard). ``margin`` is a
    scalar of this call; its cosine and sine are taken in f32, as the JAX
    step takes them of its traced f32 margin. ``num_real_classes`` < C drives
    the padded trailing columns to -1e9."""
    wn = w * torch.rsqrt(torch.clamp((w * w).sum(dim=0, keepdim=True), min=1e-12))
    cos = nn._clip(emb.to(torch.float32) @ wn, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos)
    onehot = F.one_hot(labels.long(), w.shape[1]).to(cos.dtype)
    m = np.float32(margin)
    target = torch.cos(theta + float(m))
    guard = cos > float(np.cos(np.float32(np.pi) - m))
    target = torch.where(guard, target, cos - float(m * np.sin(m)))
    out = scale * (onehot * target + (1.0 - onehot) * cos)
    if num_real_classes is not None and num_real_classes < w.shape[1]:
        col = torch.arange(w.shape[1], device=out.device)
        out = torch.where(col[None, :] < num_real_classes, out, torch.full_like(out, -1e9))
    return out


def backbone_family(arch: str = "mobilefacenet"):
    """(init_fn(seed, embed_dim) -> numpy tree, forward_fn(params, x, train=))
    for an embedder architecture name: "mobilefacenet" or an iresnet
    variant."""
    if arch == "mobilefacenet":
        return (
            lambda seed, embed_dim: init_mobilefacenet(seed, embed_dim=embed_dim),
            mobilefacenet_forward,
        )
    if arch.startswith("iresnet"):
        from frp_tpu_torch.models.iresnet import init_iresnet, iresnet_forward

        return (
            lambda seed, embed_dim: init_iresnet(seed, variant=arch, embed_dim=embed_dim),
            iresnet_forward,
        )
    raise ValueError(f"unknown embedder arch {arch!r}")


def trainable(tree, device) -> object:
    """Numpy tree (JAX layouts) -> the port's tensor tree on ``device``,
    every leaf an f32 master that requires grad and holds a zero grad (an
    optimizer step then treats a leaf the loss does not reach, such as a
    batch-statistics BN's running mean, as a zero gradient, as optax does)."""
    out = convert_params(tree, device)
    for t in flatten_params(out).values():
        t.requires_grad_(True)
        t.grad = torch.zeros_like(t)
    return out


def leaves(params) -> list[torch.Tensor]:
    return list(flatten_params(params).values())


def init_train_state(
    num_classes: int,
    embed_dim: int = 128,
    seed: int = 0,
    learning_rate: float = 0.1,
    weight_decay: float = 5e-4,
    arch: str = "mobilefacenet",
    device=None,
):
    """Returns (state, optimizer): state {"params": {"backbone", "classifier"},
    "opt_state": the optimizer, "step": 0} on ``device`` (the card unless
    named), the optimizer's momentum buffers at zero."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    init_fn, _fwd = backbone_family(arch)
    params = trainable({
        "backbone": init_fn(seed, embed_dim),
        "classifier": rng.normal(0, 0.01, size=(embed_dim, num_classes)).astype(np.float32),
    }, device)
    opt = torch.optim.SGD(leaves(params), lr=learning_rate, momentum=0.9,
                          weight_decay=weight_decay)
    for p in leaves(params):
        opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
    return {"params": params, "opt_state": opt, "step": 0}, opt


def apply_bn_updates(backbone: dict, stats: dict) -> None:
    """Write train-mode BN stats into the parameter tree, in place.

    Two path conventions, one per embedder family: mobilefacenet stats paths
    index conv_bn composites (("blocks", 3, "dw") -> the node has a "bn"
    child); iresnet paths end at a bare BN unit (("stages", 0, 1, "bn2") ->
    the node is the BN dict)."""
    with torch.no_grad():
        for path, update in stats.items():
            node = backbone
            for key in path:
                node = node[key]
            if "bn" in node:
                node = node["bn"]
            elif "mean" not in node:
                raise KeyError(f"bn-stats path {path} lands on {list(node)}")
            node["mean"].copy_(update["mean"])
            node["var"].copy_(update["var"])


def make_train_step(
    optimizer,
    mesh=None,
    scale: float = 64.0,
    compute_dtype: str = "bfloat16",
    num_real_classes: int | None = None,
    arch: str = "mobilefacenet",
):
    """The train step: step(state, images, labels, margin) -> (state,
    {"loss", "accuracy"}), the state updated in place, the metrics 0-d
    tensors on the state's device (nothing is fetched)."""
    no_mesh(mesh, "ArcFace training")
    _init, backbone_forward = backbone_family(arch)
    cdtype = getattr(torch, compute_dtype)

    def step(state, images: torch.Tensor, labels: torch.Tensor, margin: float):
        params = state["params"]
        # uint8 batches are normalised on the device, the serving convention
        # (ops.image.normalize_face): (x - 127.5) / 128
        if images.dtype == torch.uint8:
            images = (images.to(cdtype) - 127.5) / 128.0
        optimizer.zero_grad(set_to_none=False)
        emb, bn_stats = backbone_forward(params["backbone"], images.to(cdtype), train=True)
        logits = arcface_logits(emb, params["classifier"], labels, margin, scale,
                                num_real_classes=num_real_classes)
        loss = F.cross_entropy(logits, labels.long())
        loss.backward()
        optimizer.step()
        apply_bn_updates(params["backbone"], bn_stats)
        state["step"] += 1
        with torch.no_grad():
            acc = (logits.argmax(dim=-1) == labels).to(torch.float32).mean()
        return state, {"loss": loss.detach(), "accuracy": acc}

    return step


def to_device_batch(x, device: torch.device, dtype=None) -> torch.Tensor:
    """A host array (or tensor) -> a tensor on ``device``. From the host to
    the card the bytes go through pinned memory without a wait, so the host
    goes on to the next batch while the card works."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def fetch_metrics(metrics: list[dict]) -> list[dict]:
    """Device metric dicts -> host floats, in one copy."""
    if not metrics:
        return []
    keys = list(metrics[0])
    got = torch.stack([torch.stack([m[k].to(torch.float32) for k in keys]) for m in metrics])
    return [dict(zip(keys, map(float, row))) for row in got.cpu().numpy()]


class ArcFaceTrainer:
    """Host-facing trainer: owns the state, the placement and the FL delta
    contract. ``weights_delta()`` exports {layer_name: array} differences in
    the flat format of the federated service's upload route; a client trains
    locally, then uploads."""

    def __init__(
        self,
        num_classes: int,
        embed_dim: int = 128,
        mesh=None,
        seed: int = 0,
        learning_rate: float = 0.1,
        compute_dtype: str = "bfloat16",
        arch: str = "mobilefacenet",
        margin: float = 0.5,
        device=None,
    ):
        no_mesh(mesh, "ArcFace training")
        self.device = resolve_device(device)
        self.margin = float(margin)  # the default; train_step(margin=) overrides
        self.num_classes = num_classes
        self.arch = arch
        self.state, self.optimizer = init_train_state(
            num_classes, embed_dim, seed, learning_rate, arch=arch, device=self.device)
        self._initial_backbone = self.embedder_params()
        self._step = make_train_step(self.optimizer, compute_dtype=compute_dtype, arch=arch)
        self.history: list[dict] = []
        self._pending: list = []  # device metrics awaiting flush_metrics()

    def train_step(self, images, labels, sync: bool = True,
                   margin: float | None = None) -> dict | None:
        """images [B, 112, 112, 3]: float (-1..1 normalized) or uint8 (0..255,
        normalized on the device: a quarter of the bytes to upload); labels
        [B] int. sync=False leaves the step's metrics on the device;
        flush_metrics() fetches them all in one copy. margin overrides the
        trainer's default for this step (margin warmup)."""
        x = images if isinstance(images, torch.Tensor) else np.asarray(images)
        dtype = None if x.dtype in (np.uint8, torch.uint8) else torch.float32
        self.state, metrics = self._step(
            self.state, to_device_batch(x, self.device, dtype),
            to_device_batch(labels, self.device, torch.int64),
            self.margin if margin is None else margin)
        if not sync:
            self._pending.append(metrics)
            return None
        self.flush_metrics()  # keep history ordered if sync and async steps mix
        entry = fetch_metrics([metrics])[0]
        entry["step"] = self.state["step"]
        self.history.append(entry)
        return entry

    def flush_metrics(self) -> list[dict]:
        """Fetch all sync=False step metrics with one device-to-host copy."""
        entries = fetch_metrics(self._pending)
        self._pending = []
        self.history.extend(entries)
        return entries

    def embedder_params(self):
        """The backbone as a numpy tree in the JAX layouts (``save_params``
        writes it; the JAX engine's ``load_params`` reads that file)."""
        return to_numpy_params(self.state["params"]["backbone"])

    def weights_delta(self) -> dict:
        """Flat {name: delta array} against the initial backbone: the FL
        upload, named as the JAX package's ``_flatten_tree`` names it."""
        flat_now = flatten_tree(self.embedder_params())
        flat_init = flatten_tree(self._initial_backbone)
        return {k: flat_now[k] - flat_init[k] for k in flat_now}


def flatten_tree(tree, prefix: str = "") -> dict:
    """{"blocks.0.expand.conv.w": array}: the dotted names of
    ``frp_tpu/train/arcface.py::_flatten_tree``, the FL wire format."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out
