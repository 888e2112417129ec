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

Over a process mesh (``parallel.make_global_mesh``, one process a position:
data x model), the JAX package's sharded step, written out with
``torch.distributed``: each rank takes its data position's rows of the
global batch; BN takes the global batch's statistics (``nn.batch_norm``'s
group); the classifier [D, C] is drawn whole at C padded to a multiple of
the model axis and each model rank keeps its columns (its SGD momentum is
that slice); the margin goes on the rank that holds the label's column and
the pad columns are masked by their global index; the softmax takes its max
and its sum over the model group, and the embedding's gradient is summed
over it before the backbone's backward; the classifier shard's gradient is
averaged over the data group, and the backbone's over every rank (the
model ranks of a data row see the same rows, so that is the data mean, and
every replica takes the same update bit for bit: ``MeshSplit``). Loss and
accuracy are the global
batch's. An axis of one position has no group and takes no collective: its
BN takes the rank's own rows, its argmax is the one-card one, and a mesh of
one rank steps as one card. A single-process mesh of several positions
raises: torch's collectives join processes, so start one process a
position.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from frp_tpu_torch.engine.pipeline import resolve_device
from frp_tpu_torch.models import nn
from frp_tpu_torch.models.mobilefacenet import init_mobilefacenet, mobilefacenet_forward
from frp_tpu_torch.models.params import convert_params, flatten_params, to_numpy_params
from frp_tpu_torch.parallel.collectives import (
    argmax_over,
    average_gradients,
    gather_columns,
    mean_over,
    reduce_sum_backward,
    reduce_sum_forward,
)
from frp_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, data_rows, model_columns


class MeshSplit:
    """A trainer's place in its mesh: this process's data and model
    positions and the process groups of its mesh column (``data``) and row
    (``model``). A group of one rank is None, so no collective runs over it
    (a collective over one rank is the identity, and costs its launch and
    the backend's call). With no mesh, a single-process mesh of one
    position or a process mesh of one rank: no groups, the one-card
    step."""

    def __init__(self, mesh=None, what: str = "training"):
        self.mesh = mesh
        self.n_data = self.n_model = 1
        self.i = self.j = 0
        self.data = self.model = None
        if mesh is None:
            return
        if not mesh.is_process_mesh:
            if mesh.devices.size > 1:
                raise ValueError(
                    f"{what} over a {mesh.shape} mesh runs one process a position: start "
                    f"{mesh.devices.size} processes (torchrun --nproc-per-node, or "
                    "FRP_COORDINATOR, FRP_NUM_PROCESSES and FRP_PROCESS_ID), call "
                    "parallel.distributed_initialize() and pass parallel.make_global_mesh()")
            return
        self.n_data, self.n_model = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
        self.i, self.j = mesh.position
        self.data = mesh.get_group(DATA_AXIS) if self.n_data > 1 else None
        self.model = mesh.get_group(MODEL_AXIS) if self.n_model > 1 else None

    @property
    def alone(self) -> bool:
        """No group on either axis: the step is one card's."""
        return self.data is None and self.model is None

    def rows(self, x):
        """This data position's rows of a global batch (array or tensor)."""
        if self.n_data == 1:
            return x
        return x[data_rows(len(x), self.mesh)[self.i]]

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """A rank's mean over its rows -> the global batch's mean."""
        return x if self.data is None else mean_over(x, self.data, self.n_data)

    def average_gradients(self, params: list[torch.Tensor], own_columns: bool = False) -> None:
        """Gradients averaged over the global batch's data positions. A
        replicated parameter's are averaged over every rank: the model ranks
        of a data position take the same rows, so this is the data mean, and
        every replica takes the same update bit for bit (on the card a
        conv's weight gradient is summed in no fixed order, so each model
        rank's own would differ in its last bits and the replicas would
        drift apart). A model rank's ``own_columns`` are averaged over its
        data group. A mesh of one rank averages nothing."""
        if own_columns or self.model is None:
            if self.data is not None:
                average_gradients(params, self.data, self.n_data)
        else:
            average_gradients(params, None, self.n_data * self.n_model)

    def tag(self, state: dict, model_columns: tuple = ()) -> dict:
        """On a process mesh, mark a trainer state with the mesh and the
        parameters split by columns over its model axis, for the
        checkpoint's gather and rank-0 write (``train/checkpoint.py``)."""
        if self.mesh is not None and self.mesh.is_process_mesh:
            state.update(mesh=self.mesh, model_columns=model_columns)
        return state


def trainer_device(mesh, device) -> torch.device:
    """A trainer's device: this process's position on a mesh (``device``
    must then be None or the same), else ``device``, the card unless
    named."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not this process's position {mesh.device}")
    return mesh.device


def arcface_logits(
    emb: torch.Tensor,
    w: torch.Tensor,
    labels: torch.Tensor,
    margin: float = 0.5,
    scale: float = 64.0,
    num_real_classes: int | None = None,
    col_offset: int = 0,
) -> torch.Tensor:
    """emb [B, D] (normalized), w [D, C] -> margined, scaled logits [B, C] in
    f32 (``frp_tpu/train/arcface.py:38-72``). ``w`` may be a model rank's
    columns of the classifier, the first of them global column
    ``col_offset``: the margin goes only where the label's column is local,
    and the pad mask reads the global index.

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
    col = col_offset + torch.arange(w.shape[1], device=cos.device)
    onehot = (labels.long()[:, None] == col[None, :]).to(cos.dtype)
    m = np.float32(margin)
    target = torch.cos(theta + float(m))
    guard = cos > float(np.cos(np.float32(np.pi) - m))
    target = torch.where(guard, target, cos - float(m * np.sin(m)))
    out = scale * (onehot * target + (1.0 - onehot) * cos)
    if num_real_classes is not None and num_real_classes < col_offset + w.shape[1]:
        out = torch.where(col[None, :] < num_real_classes, out, torch.full_like(out, -1e9))
    return out


def sharded_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, col_offset: int,
                          group) -> torch.Tensor:
    """The mean softmax cross-entropy of logits whose columns are split over
    a model group (this rank's first column is ``col_offset``): the row max
    and the normaliser's sum over the group, the label's logit from the
    rank that holds it. Every rank gets the same loss; the gradient reaches
    each rank's own columns. ``group`` None (a model axis of one): the same
    arithmetic on this rank's columns alone, with no collective, which
    rounds as the collective path does (``F.cross_entropy`` rounds the
    logits' gradient otherwise, by some 1e-8)."""
    with torch.no_grad():
        m = logits.max(dim=-1).values
        if group is not None:
            torch.distributed.all_reduce(m, op=torch.distributed.ReduceOp.MAX, group=group)
    total = torch.exp(logits - m[:, None]).sum(dim=-1)
    col = col_offset + torch.arange(logits.shape[1], device=logits.device)
    mine = (labels.long()[:, None] == col[None, :]).to(logits.dtype)
    target = (logits * mine).sum(dim=-1)
    if group is not None:
        total, target = reduce_sum_forward(total, group), reduce_sum_forward(target, group)
    return (torch.log(total) + m - target).mean()


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
    columns: slice | None = None,
):
    """Returns (state, optimizer): state {"params": {"backbone", "classifier"},
    "opt_state": the optimizer, "step": 0} on ``device`` (the card unless
    named), the optimizer's momentum buffers at zero. ``columns`` keeps a
    model rank's slice of the classifier, drawn whole as without a mesh."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    init_fn, _fwd = backbone_family(arch)
    classifier = rng.normal(0, 0.01, size=(embed_dim, num_classes)).astype(np.float32)
    params = trainable({
        "backbone": init_fn(seed, embed_dim),
        "classifier": np.ascontiguousarray(classifier[:, columns or slice(None)]),
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
    tensors on the state's device (nothing is fetched). Over a process
    ``mesh`` the step takes this rank's rows of the global batch
    (``MeshSplit.rows``) and its classifier columns, and its metrics are
    the global batch's."""
    split = MeshSplit(mesh, "ArcFace training")
    _init, backbone_forward = backbone_family(arch)
    cdtype = getattr(torch, compute_dtype)

    def step(state, images: torch.Tensor, labels: torch.Tensor, margin: float):
        params = state["params"]
        w = params["classifier"]
        offset = split.j * w.shape[1]
        # uint8 batches are normalised on the device, the serving convention
        # (ops.image.normalize_face): (x - 127.5) / 128
        if images.dtype == torch.uint8:
            images = (images.to(cdtype) - 127.5) / 128.0
        optimizer.zero_grad(set_to_none=False)
        emb, bn_stats = backbone_forward(params["backbone"], images.to(cdtype), train=True,
                                         bn_group=split.data)
        if split.model is not None:
            emb = reduce_sum_backward(emb, split.model)
        logits = arcface_logits(emb, w, labels, margin, scale,
                                num_real_classes=num_real_classes, col_offset=offset)
        if split.alone:
            loss = F.cross_entropy(logits, labels.long())
        else:
            loss = sharded_cross_entropy(logits, labels, offset, split.model)
        loss.backward()
        split.average_gradients(leaves(params["backbone"]))
        split.average_gradients([w], own_columns=True)
        optimizer.step()
        apply_bn_updates(params["backbone"], bn_stats)
        state["step"] += 1
        with torch.no_grad():
            pred = (logits.argmax(dim=-1) if split.model is None
                    else argmax_over(logits, offset, split.model))
            acc = split.mean((pred == labels).to(torch.float32).mean())
        return state, {"loss": split.mean(loss.detach()), "accuracy": acc}

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
    locally, then uploads.

    With a process ``mesh`` every process builds the trainer and calls
    ``train_step`` with the same global batch; the backbone, and so
    ``embedder_params`` and ``weights_delta``, is the same on every rank and
    what a one-card trainer writes; ``gather_classifier`` joins the
    classifier's (or its momentum's) columns, and ``save_checkpoint``, called
    on every rank, writes the whole state once."""

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
        self.mesh = mesh
        self.split = MeshSplit(mesh, "ArcFace training")
        self.device = trainer_device(mesh, device)
        self.margin = float(margin)  # the default; train_step(margin=) overrides
        self.num_classes = num_classes
        self.arch = arch
        # the class axis must divide the model axis: the classifier is padded
        # up and the pad classes masked out of the loss (num_real_classes)
        n_model = self.split.n_model
        padded = -(-num_classes // n_model) * n_model
        columns = model_columns(padded, mesh)[self.split.j] if mesh is not None else None
        self.state, self.optimizer = init_train_state(
            padded, embed_dim, seed, learning_rate, arch=arch, device=self.device,
            columns=columns)
        self.split.tag(self.state, ("classifier",))
        self._initial_backbone = self.embedder_params()
        self._step = make_train_step(
            self.optimizer, mesh, compute_dtype=compute_dtype,
            num_real_classes=num_classes if padded != num_classes else None, arch=arch)
        self.history: list[dict] = []
        self._pending: list = []  # device metrics awaiting flush_metrics()

    def train_step(self, images, labels, sync: bool = True,
                   margin: float | None = None) -> dict | None:
        """images [B, 112, 112, 3]: float (-1..1 normalized) or uint8 (0..255,
        normalized on the device: a quarter of the bytes to upload); labels
        [B] int. sync=False leaves the step's metrics on the device;
        flush_metrics() fetches them all in one copy. margin overrides the
        trainer's default for this step (margin warmup). Over a mesh, the
        global batch: each rank uploads its own rows."""
        x = images if isinstance(images, torch.Tensor) else np.asarray(images)
        dtype = None if x.dtype in (np.uint8, torch.uint8) else torch.float32
        self.state, metrics = self._step(
            self.state, to_device_batch(self.split.rows(x), self.device, dtype),
            to_device_batch(self.split.rows(labels), self.device, torch.int64),
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

    def gather_classifier(self, tensor: torch.Tensor | None = None) -> np.ndarray:
        """The classifier [D, C] (C padded to the model axis), or a tensor
        split like it (its momentum buffer), whole, as a host array; over a
        mesh every rank of a model row joins its columns."""
        t = self.state["params"]["classifier"] if tensor is None else tensor
        if self.split.model is not None:
            t = gather_columns(t, self.mesh)
        return t.detach().cpu().numpy()

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
