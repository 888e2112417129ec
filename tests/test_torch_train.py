"""PyTorch port, training (1 of 3): the training BN, both embedders'
training forward, the ArcFace logits and the ArcFace trainer, on the CPU
against the JAX package, the same numpy inputs through both at f32.

Tolerances, and what was measured:

- BN train outputs and stats, the training forwards and their stats:
  rtol 1e-4 and atol 1e-5, or atol 1e-4 for iresnet18 as
  tests/test_torch_iresnet.py holds its forward (measured 2.1e-5 there).
- ``arcface_logits``: atol 1e-4 on logits of scale 64 (measured 8e-6).
- A trainer step from the same state, at batch 4: the loss within 1e-4
  relative and the accuracy equal; every parameter and running stat within
  1e-5 absolute plus 1e-4 relative (the worst leaf at 0.48 of that
  tolerance, MobileFaceNet, 0.25 iresnet18); each momentum buffer (the step's
  gradient plus decay) within 2e-2 of its L2 norm plus 1e-3 of the tree's
  largest entry (measured 8.6e-3).
- Three steps run apart, each on its own batch: the accuracy equal at every
  step, the loss within 1e-4 relative at the first and 1e-3 at the next two
  (measured 2.3e-4).

Why the steps compared leaf for leaf start from the same state, and run at a
learning rate of 1e-4: the f32 gradient of a randomly initialised embedder
over 4 images is itself ill-conditioned. The port's f32 step against the same
step in f64 differs by up to 3-6 % of a leaf's update (MobileFaceNet, the
expand convs and BN betas of the middle blocks), and JAX's f32 step differs
from the port's by as much; after one update the next loss moves with it.
So independent runs agree in the loss, and leaf by leaf only as far as that
floor: the third step is compared from JAX's state after two steps, copied
into the port (parameters, momentum buffers, step), which holds the update
with nonzero momentum and decayed weights at the tight tolerance.
"""

import jax
import numpy as np
import pytest
import torch

from frp_tpu.models import nn as jnn
from frp_tpu.models.iresnet import init_iresnet as j_init_ir
from frp_tpu.models.iresnet import iresnet_forward as j_ir
from frp_tpu.models.mobilefacenet import init_mobilefacenet as j_init_mfn
from frp_tpu.models.mobilefacenet import mobilefacenet_forward as j_mfn
from frp_tpu.train.arcface import ArcFaceTrainer as JTrainer
from frp_tpu.train.arcface import _flatten_tree as j_flatten_tree
from frp_tpu.train.arcface import arcface_logits as j_logits

from frp_tpu_torch.models import nn as tnn
from frp_tpu_torch.models.iresnet import iresnet_forward as t_ir
from frp_tpu_torch.models.mobilefacenet import mobilefacenet_forward as t_mfn
from frp_tpu_torch.models.params import convert_params, flatten_params, to_numpy_params
from frp_tpu_torch.train import ArcFaceTrainer, arcface_logits, init_train_state
from frp_tpu_torch.train.arcface import backbone_family, leaves
from frp_tpu_torch.train.synthetic import make_identity, make_identity_crop

FWD = dict(rtol=1e-4, atol=1e-5)
NC = 4  # identities
LR = 1e-4


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs its files in parallel worker processes: two intra-op
    threads a test keep those from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat_j(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_params(jax.device_get(tree)).items()}


def _flat_t(tree) -> dict:
    """A port tensor tree as flat numpy in the JAX layouts."""
    return flatten_params(to_numpy_params(tree))


def _like(tree, fn):
    """The tree's structure with fn(leaf) at each tensor leaf."""
    if isinstance(tree, dict):
        return {k: _like(v, fn) for k, v in tree.items() if not k.startswith("_")}
    if isinstance(tree, list):
        return [_like(v, fn) for v in tree]
    return fn(tree)


def _buffers_t(tr) -> dict:
    """The port trainer's momentum buffers, flat, in the JAX layouts."""
    return _flat_t(_like(tr.state["params"], lambda p: tr.optimizer.state[p]["momentum_buffer"]))


def _state_j(tr) -> dict:
    """A JAX trainer's state on the host: params, momentum trace, step."""
    st = jax.device_get(tr.state)
    return {"params": st["params"], "trace": st["opt_state"][1][0].trace, "step": int(st["step"])}


def _load_into_port(tr, st) -> None:
    """Copy a JAX trainer state (_state_j) into the port trainer."""
    params = flatten_params(convert_params(st["params"]))
    trace = flatten_params(convert_params(st["trace"]))
    with torch.no_grad():
        for k, p in flatten_params(tr.state["params"]).items():
            p.copy_(params[k])
            tr.optimizer.state[p]["momentum_buffer"].copy_(trace[k])
    tr.state["step"] = st["step"]


def _assert_params(got: dict, want: dict, what: str) -> None:
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=f"{what} {k}")


def _assert_buffers(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    top = max(np.abs(v).max() for v in want.values())
    for k in want:
        err = np.linalg.norm(got[k] - want[k])
        assert err <= 2e-2 * (np.linalg.norm(want[k]) + 1e-3 * top), (k, err, np.linalg.norm(want[k]))


def _crops(seed: int, b: int = 4, nc: int = NC):
    """b uint8 identity crops (ArcFace training samples) and their labels."""
    rng = np.random.default_rng(seed)
    ids = [make_identity(i) for i in range(nc)]
    labels = (np.arange(b) % nc).astype(np.int32)
    return np.stack([make_identity_crop(ids[l], rng) for l in labels]), labels


# --- BN and the training forwards ------------------------------------------

@pytest.mark.parametrize("shape", [(4, 6, 5, 5), (4, 6)])
def test_batch_norm_train_equals_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(1.5, 2.0, size=shape).astype(np.float32)
    p = {"gamma": rng.uniform(0.5, 1.5, shape[1]).astype(np.float32),
         "beta": rng.normal(size=shape[1]).astype(np.float32),
         "mean": rng.normal(size=shape[1]).astype(np.float32),
         "var": rng.uniform(0.5, 2.0, shape[1]).astype(np.float32)}
    nhwc = x.transpose(0, 2, 3, 1) if x.ndim == 4 else x
    want_y, want = jnn.batch_norm(p, nhwc, train=True)
    got_y, got = tnn.batch_norm(convert_params(p), torch.from_numpy(x), train=True)
    got_y = got_y.numpy()
    np.testing.assert_allclose(got_y.transpose(0, 2, 3, 1) if x.ndim == 4 else got_y, want_y, **FWD)
    for k in ("mean", "var"):  # 0.9 old + 0.1 batch, the biased variance
        np.testing.assert_allclose(got[k].numpy(), want[k], **FWD)
    # the inference fold is untouched by the training mode
    np.testing.assert_allclose(
        tnn.batch_norm(convert_params(p), torch.from_numpy(x)).numpy(),
        np.asarray(jnn.batch_norm(p, nhwc)).transpose(0, 3, 1, 2) if x.ndim == 4
        else np.asarray(jnn.batch_norm(p, nhwc)), **FWD)


def test_batch_norm_train_bf16_stats_in_f32():
    """At bf16 the statistics are taken in f32 and the output rounds once."""
    rng = np.random.default_rng(1)
    x = rng.normal(0.3, 1.0, size=(4, 8, 6, 6)).astype(np.float32)
    p = {"gamma": np.ones(8, np.float32), "beta": np.zeros(8, np.float32),
         "mean": np.zeros(8, np.float32), "var": np.ones(8, np.float32)}
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y, st = tnn.batch_norm(convert_params(p), xb, train=True)
    assert y.dtype == torch.bfloat16 and st["mean"].dtype == torch.float32
    want_y, want = jnn.batch_norm(p, jax.numpy.asarray(x.transpose(0, 2, 3, 1), jax.numpy.bfloat16),
                                  train=True)
    np.testing.assert_allclose(st["var"].numpy(), want["var"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y.float().numpy().transpose(0, 2, 3, 1),
                               np.asarray(want_y, np.float32), atol=2e-2)


@pytest.mark.parametrize("arch", ["mobilefacenet", "iresnet18"])
def test_training_forward_and_stats_paths_equal_jax(arch):
    j_init, j_fwd, t_fwd = {"mobilefacenet": (j_init_mfn, j_mfn, t_mfn),
                            "iresnet18": (j_init_ir, j_ir, t_ir)}[arch]
    tree = j_init(2)
    x, _ = _crops(7)
    xf = (x.astype(np.float32) - 127.5) / 128.0
    want_emb, want = j_fwd(tree, xf, train=True)
    got_emb, got = t_fwd(convert_params(tree), torch.from_numpy(xf), train=True)
    assert set(got) == set(want)  # the same tuple paths, per family
    # iresnet18: atol 1e-4, as tests/test_torch_iresnet.py holds its forward
    tol = FWD if arch == "mobilefacenet" else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_emb.detach().numpy(), want_emb, **tol)
    for path in want:
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[path][k].numpy(), want[path][k], err_msg=str(path), **tol)
    # inference is unchanged by the new argument
    np.testing.assert_allclose(t_fwd(convert_params(tree), torch.from_numpy(xf)).numpy(),
                               j_fwd(tree, xf), **tol)


# --- the ArcFace logits ------------------------------------------------------

@pytest.mark.parametrize("margin,num_real", [(0.0, None), (0.5, None), (0.5, 6), (2.9, None)])
def test_arcface_logits_equal_jax(margin, num_real):
    """margin 2.9 puts most targets past the easy-margin guard (theta >
    pi - m); num_real_classes masks padded columns to -1e9."""
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(6, 16)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    labels = np.array([0, 1, 2, 3, 4, 5])
    want = np.asarray(j_logits(emb, w, labels, margin, num_real_classes=num_real))
    got = arcface_logits(torch.from_numpy(emb), torch.from_numpy(w), torch.from_numpy(labels),
                         margin, num_real_classes=num_real).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if margin == 2.9:
        cos = emb @ (w / np.linalg.norm(w, axis=0))
        assert (cos[np.arange(6), labels] <= np.cos(np.pi - 2.9)).sum() >= 3
    if num_real:
        assert (got[:, num_real:] == -1e9).all()


# --- the trainer ---------------------------------------------------------------

@pytest.fixture(scope="module", params=["mobilefacenet", "iresnet18"])
def runs(request):
    """Both packages' trainers, f32, seed 0, three steps on three batches;
    the JAX state after each step, and the port trainer's numbers."""
    arch = request.param
    batches = [_crops(10 + s) for s in range(3)]
    jt = JTrainer(num_classes=NC, seed=0, learning_rate=LR, compute_dtype="float32", arch=arch)
    tt = ArcFaceTrainer(num_classes=NC, seed=0, learning_rate=LR, compute_dtype="float32",
                        arch=arch, device="cpu")
    out = {"arch": arch, "batches": batches, "j": [], "t": [], "j_state": [_state_j(jt)]}
    t_step1 = None
    for s, (x, y) in enumerate(batches):
        out["j"].append(jt.train_step(x, y))
        out["j_state"].append(_state_j(jt))
        out["t"].append(tt.train_step(x, y))
        if s == 0:
            t_step1 = (_flat_t(tt.state["params"]), _buffers_t(tt))
    out["t_step1"] = t_step1
    return out


def test_initial_state_equals_jax(runs):
    tt = ArcFaceTrainer(num_classes=NC, seed=0, compute_dtype="float32", arch=runs["arch"],
                        device="cpu")
    want = runs["j_state"][0]
    got = _flat_t(tt.state["params"])
    for k, v in flatten_params(want["params"]).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert all(not b.any() for b in _buffers_t(tt).values())
    assert tt.state["step"] == 0


def test_first_step_equals_jax(runs):
    want = runs["j_state"][1]
    got_params, got_bufs = runs["t_step1"]
    j, t = runs["j"][0], runs["t"][0]
    assert t["step"] == j["step"] == 1 and t["accuracy"] == j["accuracy"]
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
    _assert_params(got_params, {k: np.asarray(v) for k, v in flatten_params(want["params"]).items()},
                   "step 1")
    _assert_buffers(got_bufs, {k: np.asarray(v) for k, v in flatten_params(want["trace"]).items()})


def test_three_steps_loss_and_accuracy_follow_jax(runs):
    for s, (j, t) in enumerate(zip(runs["j"], runs["t"])):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4 if s == 0 else 1e-3)
        assert t["accuracy"] == j["accuracy"] and t["step"] == j["step"]


def test_third_step_from_the_same_state_equals_jax(runs):
    """JAX's state after two steps, copied into a port trainer; the third
    step (nonzero momentum, decayed weights) on both."""
    tt = ArcFaceTrainer(num_classes=NC, seed=0, learning_rate=LR, compute_dtype="float32",
                        arch=runs["arch"], device="cpu")
    _load_into_port(tt, runs["j_state"][2])
    x, y = runs["batches"][2]
    got = tt.train_step(x, y)
    j = runs["j"][2]
    np.testing.assert_allclose(got["loss"], j["loss"], rtol=1e-4)
    assert got["accuracy"] == j["accuracy"] and got["step"] == 3
    want = runs["j_state"][3]
    _assert_params(_flat_t(tt.state["params"]),
                   {k: np.asarray(v) for k, v in flatten_params(want["params"]).items()}, "step 3")
    _assert_buffers(_buffers_t(tt), {k: np.asarray(v) for k, v in flatten_params(want["trace"]).items()})


def _port(**kw):
    return ArcFaceTrainer(num_classes=NC, seed=0, learning_rate=0.05, compute_dtype="float32",
                          device="cpu", **kw)


def test_uint8_batch_equals_float_batch():
    x, y = _crops(20, b=2)
    a, b = _port(), _port()
    ma = a.train_step(x, y)
    mb = b.train_step((x.astype(np.float32) - 127.5) / 128.0, y)
    assert ma == mb
    for k, v in _flat_t(a.state["params"]).items():
        np.testing.assert_array_equal(v, _flat_t(b.state["params"])[k], err_msg=k)


def test_async_steps_and_flush_equal_sync_steps():
    batches = [_crops(30 + s, b=2) for s in range(2)]
    a, b = _port(), _port()
    want = [a.train_step(x, y) for x, y in batches]
    assert [b.train_step(x, y, sync=False) for x, y in batches] == [None, None]
    got = b.flush_metrics()
    assert [{k: e[k] for k in ("loss", "accuracy")} for e in want] == got
    assert b.history == got and b.flush_metrics() == [] and b.state["step"] == 2
    b.train_step(*batches[0])  # a sync step after async ones keeps the history in order
    assert len(b.history) == 3 and b.history[-1]["step"] == 3


def test_margin_override_is_live():
    """train_step(margin=) overrides the default for one step: margin 0 from
    the same state gives a lower loss, and equals a trainer built with it."""
    x, y = _crops(40, b=2)
    m0 = _port().train_step(x, y, margin=0.0)
    m5 = _port().train_step(x, y)
    assert m0["loss"] < m5["loss"]
    assert _port(margin=0.0).train_step(x, y) == m0


def test_weights_delta_names_and_values_equal_jax():
    x, y = _crops(50)
    jt = JTrainer(num_classes=NC, seed=0, learning_rate=LR, compute_dtype="float32")
    tt = ArcFaceTrainer(num_classes=NC, seed=0, learning_rate=LR, compute_dtype="float32",
                        device="cpu")
    jt.train_step(x, y)
    tt.train_step(x, y)
    want, got = jt.weights_delta(), tt.weights_delta()
    assert set(got) == set(want) == set(j_flatten_tree(j_init_mfn(0)))
    assert "blocks.0.expand.conv.w" in got and len(got) > 50
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    assert any(v.any() for v in got.values())


def test_bf16_step_loss_within_one_percent_of_jax():
    """At batch 8: at 2, the BN after the 1x1 gdconv maps normalises two
    values a channel to +-1, and a bf16 rounding that swaps the two flips
    the sign (measured: the port's bf16 loss 12 % off JAX's at batch 2, in
    f32 1e-4; at batch 8, 0.3 % and 2e-7)."""
    x, y = _crops(60, b=8)
    j = JTrainer(num_classes=NC, seed=0, learning_rate=0.05).train_step(x, y)
    t = ArcFaceTrainer(num_classes=NC, seed=0, learning_rate=0.05, device="cpu").train_step(x, y)
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-2)


# --- device policy and the state's API ---------------------------------------

def test_trainer_means_the_card_and_takes_a_mesh(runs):
    """A mesh is taken (it raised NotImplementedError before the mesh was
    ported): a mesh of one position is the one-card step, JAX's first step;
    a single-process mesh of several positions raises, since torch's
    collectives join processes (tests/test_torch_mesh_train.py runs one
    process a position against JAX's sharded step)."""
    from frp_tpu_torch.parallel import make_mesh

    assert not torch.cuda.is_available()  # this suite runs on a CPU host
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ArcFaceTrainer(num_classes=NC)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_train_state(NC)
    with pytest.raises(ValueError, match="one process a position"):
        ArcFaceTrainer(num_classes=NC, mesh=make_mesh(n_data=2, devices=["cpu", "cpu"]))
    tt = ArcFaceTrainer(num_classes=NC, seed=0, learning_rate=LR, compute_dtype="float32",
                        arch=runs["arch"], mesh=make_mesh(n_data=1, devices=["cpu"]))
    assert tt.device == torch.device("cpu")
    got = tt.train_step(*runs["batches"][0])
    j = runs["j"][0]
    assert got["step"] == 1 and got["accuracy"] == j["accuracy"]
    np.testing.assert_allclose(got["loss"], j["loss"], rtol=1e-4)
    _assert_params(_flat_t(tt.state["params"]),
                   {k: np.asarray(v) for k, v in flatten_params(runs["j_state"][1]["params"]).items()},
                   "one-position mesh")


def test_init_train_state_leaves_and_family():
    state, opt = init_train_state(NC, embed_dim=64, seed=1, arch="iresnet18", device="cpu")
    assert state["params"]["classifier"].shape == (64, NC) and state["step"] == 0
    assert state["opt_state"] is opt and opt.param_groups[0]["weight_decay"] == 5e-4
    # one group holds every leaf: BN stats, PReLU slopes and the classifier too
    assert len(opt.param_groups) == 1 and len(opt.param_groups[0]["params"]) == len(leaves(state["params"]))
    with pytest.raises(ValueError, match="unknown embedder arch"):
        backbone_family("resnet9")
