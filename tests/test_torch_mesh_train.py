"""PyTorch port, the mesh (2 of 2): the trainers over a process mesh, four
gloo processes on the CPU (``frp_tpu_torch/testing/ranks.py``), one torch
thread each, against the JAX package's sharded step on its 8-device CPU mesh
and against the port's one-process step, from the same seed and batch, at
f32.

- A 2 x 2 mesh: the dp x tp ArcFace step (MobileFaceNet, 4 classes, batch 8)
  against JAX's ``make_mesh(n_data=2, n_model=2)`` step; the spoof and the
  detector data-parallel steps (batch 4) against the port's one-process
  step.
- A 1 x 4 mesh: 6 classes padded to 8 on the model axis of 4, against JAX's
  ``make_mesh(n_data=1, n_model=4)`` step.
- Axes of one rank: a 2 x 1 mesh's ArcFace step makes no collective call
  over its model group of one and stays bit for bit the step that made
  them (``testing/ranks.py::one_rank_groups``); a 1 x 1 mesh makes none at
  all and steps as one process.
- chip_smoke.py's phase 14 rehearsed on the CPU at a tiny size.

Tolerances, the one-process trainers' (``tests/test_torch_train.py``,
``tests/test_torch_train_det.py``): the loss within 1e-4 relative and the
accuracy equal; every parameter and BN running stat within 1e-5 absolute
plus 1e-4 relative; the ArcFace momentum within 2e-2 of each leaf's L2 norm
plus 1e-3 of the tree's largest entry; AdamW's moments within 1e-4 relative
(1e-5 / 1e-7 absolute) and its near-zero-gradient elements within 2 lr.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from frp_tpu.parallel.mesh import make_mesh as j_make_mesh
from frp_tpu.train.arcface import ArcFaceTrainer as JTrainer

from frp_tpu_torch.models.params import flatten_params
from frp_tpu_torch.testing.ranks import spawn_ranks, train_case, trainer_arrays
from frp_tpu_torch.train.classifier import SpoofTrainer
from frp_tpu_torch.train.detector import DetectorTrainer
from frp_tpu_torch.train.synthetic import make_batch, make_identity, make_identity_crop

ARC_LR, ADAM_LR = 1e-4, 1e-3
DET = 128


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs its files in parallel worker processes: two intra-op
    threads a test keep those from oversubscribing the host's cores (each
    spawned rank takes one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _crops(seed: int, b: int, nc: int):
    rng = np.random.default_rng(seed)
    ids = [make_identity(i) for i in range(nc)]
    labels = (np.arange(b) % nc).astype(np.int32)
    return np.stack([make_identity_crop(ids[l], rng) for l in labels]), labels


def _spoof_batch(seed: int, b: int = 4):
    rng = np.random.default_rng(seed)
    ids = [make_identity(i) for i in range(4)]
    crops = np.stack([make_identity_crop(ids[i % 4], rng) for i in range(b)]).astype(np.float32)
    return crops, (np.arange(b) % 2).astype(np.int32)


def _arc(nc: int, batch) -> dict:
    return {"kind": "arcface", "batch": batch,
            "kwargs": dict(num_classes=nc, seed=0, learning_rate=ARC_LR, compute_dtype="float32")}


SPOOF = dict(seed=0, learning_rate=ADAM_LR, compute_dtype="float32")
DETECTOR = dict(det_size=DET, seed=0, learning_rate=ADAM_LR, compute_dtype="float32")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both meshes' rank-0 results; the batches; the checkpoints that the
    ranks saved (and restored) after their step."""
    batches = {"arc": _crops(11, 8, 4), "pad": _crops(12, 4, 6), "spoof": _spoof_batch(13),
               "det": make_batch(4, DET, np.random.default_rng(14), difficulty="mix")}
    ckpt = {k: str(tmp_path_factory.mktemp("ckpt") / k) for k in ("arcface", "spoof", "padded")}
    got = spawn_ranks(4, train_case, {"device": "cpu", "n_model": 2, "cases": {
        "arcface": {**_arc(4, batches["arc"]), "checkpoint": ckpt["arcface"]},
        "spoof": {"kind": "spoof", "batch": batches["spoof"], "kwargs": SPOOF,
                  "checkpoint": ckpt["spoof"]},
        "detector": {"kind": "detector", "batch": batches["det"], "kwargs": DETECTOR},
        "padded": {**_arc(6, batches["pad"]), "n_model": 4, "checkpoint": ckpt["padded"]}}})[0]
    return {"2x2": got, "1x4": {"arcface": got["padded"]}, "batches": batches, "ckpt": ckpt}


def _jax_step(nc: int, n_data: int, n_model: int, batch) -> tuple[dict, dict]:
    jt = JTrainer(num_classes=nc, mesh=j_make_mesh(n_data=n_data, n_model=n_model), seed=0,
                  learning_rate=ARC_LR, compute_dtype="float32")
    m = jt.train_step(*batch)
    st = jax.device_get(jt.state)
    flat = lambda t: {k: np.asarray(v) for k, v in flatten_params(t).items()}  # noqa: E731
    return m, {"params": flat(st["params"]),
               "momentum_buffer": flat(st["opt_state"][1][0].trace)}


def _assert_arcface(got: dict, m: dict, want: dict, params=lambda k: True,
                    momentum=lambda k: True) -> None:
    """The metrics, and the parameters and momentum of the leaves that
    ``params`` and ``momentum`` name, of one step against another's."""
    g = got["metrics"][0]
    np.testing.assert_allclose(g["loss"], m["loss"], rtol=1e-4)
    assert g["accuracy"] == m["accuracy"] and g["step"] == 1
    assert got["params"].keys() == want["params"].keys()
    for k, w in want["params"].items():  # BN running stats are leaves here
        if params(k):
            np.testing.assert_allclose(got["params"][k], w, rtol=1e-4, atol=1e-5, err_msg=k)
    top = max(np.abs(v).max() for v in want["momentum_buffer"].values())
    for k, w in want["momentum_buffer"].items():
        if momentum(k):
            err = np.linalg.norm(got["momentum_buffer"][k] - w)
            assert err <= 2e-2 * (np.linalg.norm(w) + 1e-3 * top), (k, err)


def _one_process_step(nc: int, batch) -> tuple[dict, dict]:
    from frp_tpu_torch.train.arcface import ArcFaceTrainer

    tr = ArcFaceTrainer(device="cpu", **_arc(nc, batch)["kwargs"])
    return tr.train_step(*batch), trainer_arrays(tr, "arcface")


def _grouped(k: str) -> bool:
    """A depthwise (feature-grouped) conv's weights: dw1, gdconv and each
    block's dw."""
    return k in ("backbone/dw1/conv/w", "backbone/gdconv/conv/w") or (
        k.startswith("backbone/blocks/") and k.endswith("/dw/conv/w"))


def test_dp_tp_arcface_step_equals_jax_mesh_step(runs):
    """Against JAX's 2 x 2 step: the loss, the accuracy, the gathered
    classifier, the BN running stats, and the momentum of every leaf but the
    depthwise convs'. There the reference is at fault: its dp x tp step
    takes n_model times the gradient of each feature-grouped conv, which the
    last loop pins (its 2 x 1 and 1 x 2 steps agree with its one-device
    step). Every parameter and the whole momentum against the port's
    one-process step (held to JAX's one-device step by
    tests/test_torch_train.py). JAX's 2 x 2 parameters are not compared leaf
    for leaf: the doubled gradients move them off by their own update."""
    from frp_tpu_torch.models.mobilefacenet import init_mobilefacenet

    got = runs["2x2"]["arcface"]
    m, want = _jax_step(4, 2, 2, runs["batches"]["arc"])
    _assert_arcface(got, m, want, momentum=lambda k: not _grouped(k),
                    params=lambda k: k == "classifier" or k.endswith(("/mean", "/var")))
    _assert_arcface(got, *_one_process_step(4, runs["batches"]["arc"]))
    # the momentum after one step is the gradient plus 5e-4 x the initial weight
    init = flatten_params({"backbone": init_mobilefacenet(0)})
    grouped = [k for k in want["momentum_buffer"] if _grouped(k)]
    assert len(grouped) == 17
    for k in grouped:
        g_port = got["momentum_buffer"][k] - 5e-4 * init[k]
        g_jax = want["momentum_buffer"][k] - 5e-4 * init[k]
        assert abs(float((g_jax * g_port).sum() / (g_port * g_port).sum()) - 2.0) < 1e-2, k
    assert got["shapes"] == {"classifier": (128, 2), "momentum": (128, 2),
                             "mesh": {"data": 2, "model": 2}}


def test_classes_padded_to_the_model_axis_equal_jax(runs):
    """6 classes on a model axis of 4: the classifier is drawn at 8 columns
    and the 2 pad columns are masked by their global index, as JAX's."""
    got = runs["1x4"]["arcface"]
    assert got["shapes"]["classifier"] == got["shapes"]["momentum"] == (128, 2)
    assert got["params"]["classifier"].shape == (128, 8)
    m, want = _jax_step(6, 1, 4, runs["batches"]["pad"])
    _assert_arcface(got, m, want)


def _npz(path: str) -> dict:
    with np.load(path + ".npz") as f:
        return {k: f[k] for k in f.files}


def test_mesh_checkpoint_is_the_one_card_file(runs, tmp_path):
    """Every rank saved its state after the step and restored it into a new
    trainer over the mesh, exactly (asserted in the ranks). Rank 0 alone
    wrote the file, with the names and shapes of a one-card trainer's file:
    the 2 x 2 classifier and its momentum gathered whole, the 1 x 4 one at
    its 8 padded columns."""
    from frp_tpu_torch.train.arcface import ArcFaceTrainer
    from frp_tpu_torch.train.checkpoint import save_checkpoint

    for kind, one in (("arcface", ArcFaceTrainer(device="cpu", **_arc(4, None)["kwargs"])),
                      ("spoof", SpoofTrainer(device="cpu", **SPOOF))):
        save_checkpoint(str(tmp_path / kind), one.state)
        want, got = _npz(str(tmp_path / kind)), _npz(runs["ckpt"][kind])
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
        assert int(got["step"]) == 1
        assert os.listdir(os.path.dirname(runs["ckpt"][kind])) == [kind + ".npz"]
    arc = runs["2x2"]["arcface"]
    np.testing.assert_array_equal(got_arc := _npz(runs["ckpt"]["arcface"])["params/classifier"],
                                  arc["params"]["classifier"])
    assert got_arc.shape == (128, 4)
    np.testing.assert_array_equal(_npz(runs["ckpt"]["arcface"])["opt/classifier/momentum_buffer"],
                                  arc["momentum_buffer"]["classifier"])
    padded = _npz(runs["ckpt"]["padded"])
    assert padded["params/classifier"].shape == padded["opt/classifier/momentum_buffer"].shape == (128, 8)
    np.testing.assert_array_equal(padded["params/classifier"],
                                  runs["1x4"]["arcface"]["params"]["classifier"])


def _assert_adamw_step(got: dict, want: dict) -> None:
    """The one-step AdamW state rule of tests/test_torch_train_det.py."""
    for k, w in want["params"].items():
        tol = 1e-5 + 1e-4 * np.abs(w)
        eps_regime = np.sqrt(want["exp_avg_sq"][k] / (1 - 0.999)) < 1e-6
        tol = np.where(eps_regime, 2 * ADAM_LR, tol)
        assert (np.abs(got["params"][k] - w) <= tol).all(), (k, np.abs(got["params"][k] - w).max())
    for key, atol in (("exp_avg", 1e-5), ("exp_avg_sq", 1e-7)):
        for k, w in want[key].items():
            np.testing.assert_allclose(got[key][k], w, rtol=1e-4, atol=atol, err_msg=f"{key} {k}")


@pytest.mark.parametrize("kind", ["spoof", "detector"])
def test_data_parallel_step_equals_one_process_step(runs, kind):
    got = runs["2x2"][kind]
    make, kw, batch = {"spoof": (SpoofTrainer, SPOOF, runs["batches"]["spoof"]),
                       "detector": (DetectorTrainer, DETECTOR, runs["batches"]["det"])}[kind]
    tr = make(device="cpu", **kw)
    want = tr.train_step(*batch)
    g = got["metrics"][0]
    assert g.keys() == want.keys() and g["step"] == 1
    for k in want:
        np.testing.assert_allclose(g[k], want[k], rtol=1e-4, err_msg=k)
    _assert_adamw_step(got, trainer_arrays(tr, kind))


# --- axes of one rank -----------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank_axes():
    """Rank 0's results of a 2 x 1 mesh (today's step, and the step that
    keeps the groups of one) and of a 1 x 1 mesh, on one batch."""
    batch = _crops(11, 8, 4)
    two = spawn_ranks(2, train_case, {"device": "cpu", "n_model": 1, "cases": {
        "today": _arc(4, batch), "groups_of_one": {**_arc(4, batch), "groups_of_one": True}}})[0]
    one = spawn_ranks(1, train_case, {"device": "cpu", "cases": {"arcface": _arc(4, batch)}})[0]
    return two, one["arcface"], batch


def test_a_model_group_of_one_takes_no_collective_and_keeps_the_step(one_rank_axes):
    two, _, _ = one_rank_axes
    got, old = two["today"], two["groups_of_one"]
    assert old["collectives"].get(1, 0) > 0  # the model group's, before
    assert set(got["collectives"]) == {2} and got["collectives"][2] > 0  # the data group's
    assert got["metrics"] == old["metrics"]
    for key in ("params", "momentum_buffer"):
        assert got[key].keys() == old[key].keys()
        for k, w in old[key].items():
            np.testing.assert_array_equal(got[key][k], w, err_msg=f"{key} {k}")


def test_a_one_rank_mesh_steps_as_one_process(one_rank_axes):
    _, got, batch = one_rank_axes
    assert got["collectives"] == {} and got["shapes"]["mesh"] == {"data": 1, "model": 1}
    _assert_arcface(got, *_one_process_step(4, batch))


# --- chip_smoke.py phase 14, rehearsed on the CPU ----------------------------

@pytest.fixture(scope="module")
def smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mesh_phase_runs_on_the_cpu(smoke, monkeypatch):
    """Phase 14 at a tiny size on the CPU (4 frames at det 128, 2 ticks; the
    trainers at batch 4 and 8, 4 identities, det 128): (a) the engine over a mesh
    of the CPU twice against the unsharded engine at bf16 and f32, (b) four
    gloo processes on the CPU as the 2 x 2 mesh against one process, and the
    ArcFace checkpoint saved whole and restored, (d) the
    FL service's mesh_psum[2]. The host-sync count, the one-rank NCCL leg and
    the launch counts need the card."""
    for name, value in (("TRAIN_IDS", 4), ("TRAIN_BATCH", 8), ("TRAIN_WARM", 1), ("MESH_STEPS", 8),
                        ("DET_TRAIN", (128, 2)), ("PARITY_BATCH", 4),
                        ("PROFILE", dict(smoke.PROFILE, det_size=128, max_faces_per_frame=4,
                                         pre_nms_topk=64, det_conf_threshold=0.3))):
        monkeypatch.setattr(smoke, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(smoke, "host_syncs", lambda fn: (fn(), 0)[1])
    dev = torch.device("cpu")
    me = smoke.run_mesh_engine(dev, smoke.render_scenes(4, 128, 0), 2, 1)
    assert me["bf16"]["ok"] and me["bf16"]["slots"] > 0 and me["f32_faces"] > 0
    assert me["batches"] == 3 and me["ms_per_batch"] > 0
    mt = smoke.run_mesh_train(dev)
    assert set(mt["held"]) == {"arcface_mobilefacenet", "spoof", "detector"}
    assert mt["shapes"] == {"classifier": (128, 2), "momentum": (128, 2),
                            "mesh": {"data": 2, "model": 2}}
    assert mt["loss"][1] < mt["loss"][0] and mt["ckpt_shape"] == (128, 4)
    fl = smoke.run_mesh_fl(dev)
    assert fl["backend"] == "mesh_psum[2]" and fl["rel"] <= 1e-6
