"""PyTorch port, training (2 of 3): anchor targets and the multibox loss, the
spoof and the detector trainers, on the CPU against the JAX package, the same
numpy inputs through both at f32.

Tolerances, and what was measured:

- ``assign_targets``: labels and ``ldm_valid`` bit for bit (padded GTs, a
  forced-match tie included), the encoded targets within 1e-5 relative.
- ``multibox_loss``: within 1e-5 (relative, on losses of order 1-10).
- A trainer step from the same state (spoof at 112, detector at det 128,
  batch 4, the tools' learning rate 1e-3): the metrics within 1e-4 relative
  (the accuracy equal); every parameter, BN running stat and AdamW moment
  within 1e-5 absolute plus 1e-4 relative, after the first step and after a
  third from JAX's state after two; Adam's near-zero-gradient elements as
  ``_compare`` says. Three steps run apart: the metrics within 1e-4 at the
  first step and 1e-3 after (the few elements that the first update moves
  apart, by up to 2 lr, move the next gradients by up to 1e-3).
"""

import jax
import numpy as np
import pytest
import torch

from frp_tpu.ops.anchor_targets import assign_targets as j_assign
from frp_tpu.ops.anchor_targets import encode_boxes as j_enc_boxes
from frp_tpu.ops.anchor_targets import encode_landmarks as j_enc_ldm
from frp_tpu.ops.anchor_targets import multibox_loss as j_multibox
from frp_tpu.ops.anchors import generate_anchors as j_anchors
from frp_tpu.train.classifier import SpoofTrainer as JSpoof
from frp_tpu.train.detector import DetectorTrainer as JDetector

from frp_tpu_torch.models.params import convert_params, flatten_params, to_numpy_params
from frp_tpu_torch.ops.anchor_targets import assign_targets, encode_boxes, encode_landmarks, multibox_loss
from frp_tpu_torch.ops.anchors import generate_anchors
from frp_tpu_torch.train.classifier import SpoofTrainer
from frp_tpu_torch.train.detector import DetectorTrainer, clip_by_global_norm
from frp_tpu_torch.train.synthetic import make_batch, make_identity, make_identity_crop

TOL = dict(rtol=1e-4, atol=1e-5)
DET = 128
LR = 1e-3  # the tools' learning rate for both


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs its files in parallel worker processes: two intra-op
    threads a test keep those from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _gt(seed: int, b: int = 3, g: int = 4):
    """Scenes' GT through make_batch, plus one padded GT column."""
    imgs, boxes, ldms, valid = make_batch(b, DET, np.random.default_rng(seed), max_faces=g - 1,
                                          difficulty="mix")
    pad = lambda a: np.concatenate([a, np.zeros_like(a[:, :1])], axis=1)
    return imgs, pad(boxes), pad(ldms), pad(valid)


# --- encoding, assignment, loss ---------------------------------------------

def test_encoders_equal_jax():
    priors = generate_anchors(DET)
    rng = np.random.default_rng(0)
    lo = rng.uniform(0, 0.6, size=(priors.shape[0], 2)).astype(np.float32)
    boxes = np.concatenate([lo, lo + rng.uniform(0.02, 0.4, size=lo.shape).astype(np.float32)], 1)
    ldm = rng.uniform(0, 1, size=(priors.shape[0], 10)).astype(np.float32)
    np.testing.assert_allclose(encode_boxes(torch.from_numpy(boxes), torch.from_numpy(priors)).numpy(),
                               j_enc_boxes(boxes, priors), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(encode_landmarks(torch.from_numpy(ldm), torch.from_numpy(priors)).numpy(),
                               j_enc_ldm(ldm, priors), rtol=1e-5, atol=1e-6)


def _targets_both(boxes, ldms, valid, det=DET):
    priors = generate_anchors(det)
    np.testing.assert_array_equal(priors, j_anchors(det))
    want = [jax.device_get(j_assign(priors, boxes[i], ldms[i], valid[i])) for i in range(len(boxes))]
    got = assign_targets(torch.from_numpy(priors), torch.from_numpy(boxes), torch.from_numpy(ldms),
                         torch.from_numpy(valid))
    return priors, want, got


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_assign_targets_equal_jax(seed):
    _, boxes, ldms, valid = _gt(seed)
    _, want, got = _targets_both(boxes, ldms, valid)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got["labels"][i].numpy(), w["labels"])
        np.testing.assert_array_equal(got["ldm_valid"][i].numpy(), w["ldm_valid"])
        for k in ("loc_targets", "ldm_targets"):
            np.testing.assert_allclose(got[k][i].numpy(), w[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert (got["labels"] == 1).any() and (got["labels"] == 0).any()


def test_assign_targets_forced_match_tie_and_padding():
    """Two valid GTs whose best anchor is the same (a tie on the forced
    match: the higher GT index wins), a GT far smaller than any anchor (only
    its forced match makes it positive), and padded columns, all of whose
    -1 IoUs argmax to anchor 0: the padding never clobbers a forced match."""
    priors = generate_anchors(DET)
    c = priors[0]  # anchor 0: the padded columns' argmax
    box0 = np.array([c[0] - c[2] / 2, c[1] - c[3] / 2, c[0] + c[2] / 2, c[1] + c[3] / 2], np.float32)
    tiny = np.array([0.5, 0.5, 0.503, 0.503], np.float32)
    boxes = np.zeros((1, 5, 4), np.float32)
    boxes[0, 0], boxes[0, 1], boxes[0, 2] = box0, box0, tiny
    ldms = np.zeros((1, 5, 10), np.float32)
    ldms[0, 1] = np.linspace(0.0, 0.05, 10)
    valid = np.array([[True, True, True, False, False]])
    _, want, got = _targets_both(boxes, ldms, valid)
    np.testing.assert_array_equal(got["labels"][0].numpy(), want[0]["labels"])
    np.testing.assert_array_equal(got["ldm_valid"][0].numpy(), want[0]["ldm_valid"])
    assert got["labels"][0, 0] == 1 and got["ldm_valid"][0, 0]  # GT 1 won anchor 0
    np.testing.assert_allclose(got["ldm_targets"][0, 0].numpy(), want[0]["ldm_targets"][0], rtol=1e-5)
    assert int((got["labels"][0] == 1).sum()) >= 2  # the tiny GT kept its forced anchor


@pytest.mark.parametrize("seed", [4, 5])
def test_multibox_loss_equals_jax(seed):
    _, boxes, ldms, valid = _gt(seed)
    priors, want_t, got_t = _targets_both(boxes, ldms, valid)
    rng = np.random.default_rng(seed)
    b, a = boxes.shape[0], priors.shape[0]
    loc = rng.normal(0, 1, (b, a, 4)).astype(np.float32)
    ldm = rng.normal(0, 1, (b, a, 10)).astype(np.float32)
    cls = rng.normal(0, 2, (b, a, 2)).astype(np.float32)
    got = multibox_loss(torch.from_numpy(loc), torch.from_numpy(ldm), torch.from_numpy(cls), got_t)
    for i in range(b):
        want = jax.device_get(j_multibox(loc[i], ldm[i], cls[i], want_t[i]))
        for k, v in want.items():
            np.testing.assert_allclose(got[k][i].numpy(), v, rtol=1e-5, err_msg=k)


def test_clip_by_global_norm_is_optax():
    """g / norm * max only where the global norm exceeds max; else g as is."""
    import optax

    for scale in (0.1, 10.0):
        gs = [torch.full((3,), 2.0 * scale), torch.full((2, 2), -scale)]
        want = jax.device_get(optax.clip_by_global_norm(1.0).update([g.numpy() for g in gs], None)[0])
        clip_by_global_norm(gs, 1.0)
        for g, w in zip(gs, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6)


# --- the trainers --------------------------------------------------------------

def _adam_j(opt_state) -> tuple:
    """The ScaleByAdamState of an optax state tree."""
    if hasattr(opt_state, "mu"):
        return opt_state
    for s in opt_state if isinstance(opt_state, tuple) else ():
        found = _adam_j(s)
        if found is not None:
            return found
    return None


def _moments_t(tr) -> dict:
    """The port trainer's AdamW moments, flat in the JAX layouts."""
    def tree(key):
        def walk(node):
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items() if not k.startswith("_")}
            if isinstance(node, list):
                return [walk(v) for v in node]
            return None if node is None else tr.optimizer.state[node][key]
        return flatten_params(to_numpy_params(walk(tr.state["params"])))
    return {"mu": tree("exp_avg"), "nu": tree("exp_avg_sq")}


def _load_into_port(tt, st) -> None:
    """Copy a JAX trainer state (params, AdamW moments and count) into the
    port trainer."""
    adam = _adam_j(st["opt_state"])
    params, mu, nu = (flatten_params(convert_params(t)) for t in (st["params"], adam.mu, adam.nu))
    with torch.no_grad():
        for k, p in flatten_params(tt.state["params"]).items():
            p.copy_(params[k])
            s = tt.optimizer.state[p]
            s["exp_avg"].copy_(mu[k])
            s["exp_avg_sq"].copy_(nu[k])
            s["step"].fill_(int(adam.count))
    tt.state["step"] = int(st["step"])


def _compare(st, tt, what):
    """Params, running stats and AdamW moments of a JAX trainer state and a
    port trainer.

    Adam's update is lr * m / (sqrt(v) + eps): an element whose gradients so
    far are within 100 eps of zero (sqrt of the bias-corrected v < 1e-6)
    takes an update of any size up to lr on a change of g that the f32 floor
    can make, in both packages alike. Such elements that differ (at most
    1e-4 of all; 1 to 8 a step measured) are held within 2 lr a step; all
    others, and every moment, at the tolerances of the docstring."""
    got = flatten_params(to_numpy_params(tt.state["params"]))
    want = flatten_params(st["params"])
    adam, mom = _adam_j(st["opt_state"]), _moments_t(tt)
    t = int(adam.count)
    assert t == tt.state["step"] and got.keys() == want.keys()
    nu = {k: np.asarray(v) for k, v in flatten_params(adam.nu).items()}
    loose = 0
    for k in want:  # the running mean and var are trained leaves here
        w = np.asarray(want[k])
        tol = TOL["atol"] + TOL["rtol"] * np.abs(w)
        eps_regime = np.sqrt(nu[k] / (1 - 0.999 ** t)) < 1e-6
        loose += int((eps_regime & (np.abs(got[k] - w) > tol)).sum())
        tol = np.where(eps_regime, 2 * LR * t, tol)
        assert (np.abs(got[k] - w) <= tol).all(), (what, k, float(np.abs(got[k] - w).max()))
    assert loose <= 1e-4 * sum(v.size for v in nu.values()), loose
    for key in ("mu", "nu"):
        for k, v in flatten_params(getattr(adam, key)).items():
            np.testing.assert_allclose(mom[key][k], np.asarray(v), err_msg=f"{what} {key} {k}",
                                       rtol=1e-4, atol=1e-5 if key == "mu" else 1e-7)


def _spoof_batch(seed: int, b: int = 4):
    rng = np.random.default_rng(seed)
    ids = [make_identity(i) for i in range(4)]
    crops = np.stack([make_identity_crop(ids[i % 4], rng) for i in range(b)]).astype(np.float32)
    return (crops, (np.arange(b) % 2).astype(np.int32))


def _steps_against_jax(jt, make_port, batches, step_fn):
    """Three steps on three batches run apart (the metrics), the first
    step's state leaf for leaf, and the third step from JAX's state after
    two, copied into a fresh port trainer. Returns the port trainer."""
    tt, states = make_port(), []
    for s, batch in enumerate(batches):
        j, t = step_fn(jt, batch), step_fn(tt, batch)
        states.append(jax.device_get(jt.state))
        assert t.keys() == j.keys() and t["step"] == j["step"] == s + 1
        for k in j:  # the first step from the same state; then the floor's drift
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4 if s == 0 else 1e-3, err_msg=k)
        if s == 0:
            _compare(states[0], tt, "step 1")
    synced = make_port()
    _load_into_port(synced, states[1])
    j, t = jax.device_get(jt.history[-1]), step_fn(synced, batches[2])
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)
    _compare(states[2], synced, "step 3")
    return tt


def test_spoof_trainer_steps_equal_jax():
    jt = JSpoof(seed=0, learning_rate=LR, compute_dtype="float32")
    tt = _steps_against_jax(
        jt, lambda: SpoofTrainer(seed=0, learning_rate=LR, compute_dtype="float32", device="cpu"),
        [_spoof_batch(70 + s) for s in range(3)], lambda tr, b: tr.train_step(*b))
    assert "accuracy" in tt.history[-1]
    assert flatten_params(tt.classifier_params()).keys() == \
        flatten_params(jax.device_get(jt.classifier_params())).keys()


def test_detector_trainer_steps_equal_jax():
    jt = JDetector(det_size=DET, seed=0, learning_rate=LR, compute_dtype="float32")
    tt = _steps_against_jax(
        jt, lambda: DetectorTrainer(det_size=DET, seed=0, learning_rate=LR, compute_dtype="float32",
                                    device="cpu"),
        [_gt(80 + s, b=4) for s in range(3)], lambda tr, b: tr.train_step(*b))
    assert tt.detector_params()["stem"]["conv"]["w"].shape == (3, 3, 3, 8)  # HWIO


def test_trainers_mean_the_card_and_take_a_mesh():
    """A mesh is taken (it raised NotImplementedError before the mesh was
    ported): a mesh of one position steps as JAX's trainer does; a
    single-process mesh of several positions raises (one process a
    position: tests/test_torch_mesh_train.py)."""
    from frp_tpu_torch.parallel import make_mesh

    assert not torch.cuda.is_available()  # this suite runs on a CPU host
    one = make_mesh(n_data=1, devices=["cpu"])
    cases = ((SpoofTrainer, JSpoof, {}, _spoof_batch(70)),
             (DetectorTrainer, JDetector, {"det_size": DET}, _gt(80, b=4)))
    for make, jmake, kw, batch in cases:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(**kw)
        with pytest.raises(ValueError, match="one process a position"):
            make(mesh=make_mesh(n_data=2, devices=["cpu", "cpu"]), **kw)
        tt = make(mesh=one, seed=0, learning_rate=LR, compute_dtype="float32", **kw)
        jt = jmake(seed=0, learning_rate=LR, compute_dtype="float32", **kw)
        t, j = tt.train_step(*batch), jt.train_step(*batch)
        assert t.keys() == j.keys() and t["step"] == j["step"] == 1
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)
        _compare(jax.device_get(jt.state), tt, "one-position mesh")
