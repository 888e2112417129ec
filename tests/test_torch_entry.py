"""PyTorch port, the twin of ``__graft_entry__.entry()``
(``frp_tpu_torch/testing/entry.py``) on the CPU against the JAX entry: the
same example arguments bit for bit, and the flagship forward's 14 results.

The entry's inputs are noise frames through randomly initialised nets, and
noise is where small differences grow. At f32 the detector's boxes and
landmarks agree to 3e-5 px, but on noise a landmark 3e-5 px off moves a
crop's pixels by up to 2 of 255, and the random embedder turns that into up
to 2.1e-3 on an embedding (cosine 0.99997), over the 1e-3 that
``tests/test_torch_pipeline.py`` holds on rendered faces. So the embeddings
are held in two links: the port's crop and embed stages on the JAX
detections within 1e-4 of JAX's (4.7e-5 measured), and end to end by
cosine >= 0.9999. Every other float is held end to end within
``tests/test_torch_pipeline.py``'s bounds, and valid, count, best_idx and
is_match bit for bit. At the entry's bf16, scores 1e-4 apart reorder the
slots, so a frame's boxes are compared as a set (within 0.05 px), count and
valid are equal, and the embed stage is held by cosine >= 0.99 per crop on
the same crops (the bf16 translation rule)."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frp_tpu.engine.pipeline import build_pipeline as j_build_pipeline
from frp_tpu.engine.pipeline import build_stages as j_build_stages

from frp_tpu_torch.engine.pipeline import build_stages
from frp_tpu_torch.models.params import convert_params, flatten_params
from frp_tpu_torch.testing.entry import PIPELINE, entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"boxes", "scores", "landmarks", "valid", "count", "embeddings", "best_idx",
        "best_distance", "is_match", "topk_idx", "topk_distance", "fake_prob", "quality",
        "blur_score"}


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs its files in parallel worker processes: two intra-op
    threads a test keep those from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.entry()


def _jax(args, dtype: str) -> dict:
    fn = jax.jit(j_build_pipeline(**PIPELINE, compute_dtype=dtype))
    return {k: np.asarray(v, np.float32) if v.dtype == jnp.bfloat16 else np.asarray(v)
            for k, v in jax.device_get(fn(*args)).items()}


def _port(dtype: str) -> dict:
    fn, args = entry(device="cpu", compute_dtype=dtype)
    with torch.no_grad():
        out = fn(*args)
    return {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
            for k, v in out.items()}


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_entry_args_equal_the_reference(reference):
    _, (params, frames, gallery, gallery_valid, priors) = reference
    fn, args = entry(device="cpu")
    assert callable(fn)
    got_params, *rest = args
    assert got_params.keys() == params.keys()
    for name, tree in params.items():
        want = flatten_params(convert_params(tree))
        got = flatten_params(got_params[name])
        assert got.keys() == want.keys(), name
        for k, w in want.items():
            assert torch.equal(got[k], w), f"{name} {k}"
    for got, want in zip(rest, (frames, gallery, gallery_valid, priors)):
        assert got.dtype == torch.from_numpy(np.asarray(want)).dtype
        np.testing.assert_array_equal(got.numpy(), want)
    assert frames.shape == (2, 320, 320, 3) and gallery.shape == (128, 128)


def test_entry_defaults_to_the_card():
    assert not torch.cuda.is_available()  # this suite runs on a CPU host
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


def test_entry_matches_jax_at_f32(reference):
    _, args = reference
    want, got = _jax(args, "float32"), _port("float32")
    assert set(got) == set(want) == KEYS
    for key in KEYS:
        assert got[key].shape == want[key].shape, key
    for key in ("valid", "count", "best_idx", "is_match"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the random detector fills every slot on noise: both kernels' full work
    assert want["count"].tolist() == [8, 8]
    for key, atol in (("boxes", 1e-3), ("landmarks", 1e-3), ("scores", 1e-4),
                      ("fake_prob", 1e-3), ("quality", 1e-3), ("best_distance", 1e-3),
                      ("topk_distance", 1e-3)):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol, err_msg=key)
    np.testing.assert_array_equal(got["topk_idx"][..., 0], want["topk_idx"][..., 0])
    np.testing.assert_allclose(got["blur_score"], want["blur_score"], rtol=1e-3, atol=1e-2)
    assert _cos(got["embeddings"], want["embeddings"]).min() >= 0.9999

    # the embeddings' first link: the port's crop and embed on JAX's detections
    params, frames, _, _, priors = args
    kw = dict(det_size=PIPELINE["det_size"], max_faces=PIPELINE["max_faces"],
              pre_nms_topk=PIPELINE["pre_nms_topk"], compute_dtype="float32")
    js = j_build_stages(**kw)
    ts = build_stages(device="cpu", fused_head=False, compact=False, **kw)
    dets = {k: np.array(v) for k, v in jax.device_get(
        jax.jit(js["detect"])(params["detector"], jnp.asarray(frames), jnp.asarray(priors))).items()}
    crops = np.asarray(jax.jit(js["crop"])(jnp.asarray(frames), dets)["crops"])
    j_emb = np.asarray(jax.jit(js["embed"])(params, jnp.asarray(crops),
                                            jnp.asarray(dets["valid"]))["embeddings_flat"])
    tparams = {k: convert_params(v) for k, v in params.items()}
    with torch.no_grad():
        tcrops = ts["crop"](torch.from_numpy(frames), {k: torch.from_numpy(v) for k, v in dets.items()})
        t_emb = ts["embed"](tparams, tcrops["crops"], torch.from_numpy(dets["valid"]))
    np.testing.assert_allclose(t_emb["embeddings_flat"].numpy(), j_emb, rtol=0, atol=1e-4)


def test_entry_matches_jax_at_bf16(reference):
    _, args = reference
    want, got = _jax(args, "bfloat16"), _port("bfloat16")
    assert set(got) == set(want) == KEYS
    for key in ("valid", "count"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for f in range(2):  # each frame's boxes as a set: near-tied scores reorder slots
        apart = np.abs(got["boxes"][f][:, None] - want["boxes"][f][None]).max(-1)
        assert apart.min(axis=1).max() <= 0.05 and apart.min(axis=0).max() <= 0.05, f

    # the embed stage at bf16 on the same crops, by cosine
    params, frames, _, _, priors = args
    kw = dict(det_size=PIPELINE["det_size"], max_faces=PIPELINE["max_faces"],
              pre_nms_topk=PIPELINE["pre_nms_topk"])
    js = j_build_stages(**kw)
    ts = build_stages(device="cpu", fused_head=False, compact=False, **kw)
    dets = jax.jit(js["detect"])(params["detector"], jnp.asarray(frames), jnp.asarray(priors))
    crops = np.array(jax.jit(js["crop"])(jnp.asarray(frames), dets)["crops"])
    valid = np.array(dets["valid"])
    j_emb = np.asarray(jax.jit(js["embed"])(params, jnp.asarray(crops), jnp.asarray(valid))[
        "embeddings_flat"], np.float32)
    with torch.no_grad():
        t_emb = ts["embed"]({k: convert_params(v) for k, v in params.items()},
                            torch.from_numpy(crops), torch.from_numpy(valid))["embeddings_flat"]
    assert _cos(t_emb.float().numpy(), j_emb).min() >= 0.99


def test_entry_phase_runs_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 16 rehearsed on the CPU (one timed call): the
    results' checks and the f32 comparison; the kernels' launches and times
    need the card."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(smoke, "ENTRY_CALLS", 1)
    out = smoke.run_entry(torch.device("cpu"))
    assert out["count"] == [8, 8] and out["f32_faces"] == 16 and out["kernels"] == {}
    assert out["f32_max_abs_err"]["boxes"] == 0 and out["ms"] > 0
