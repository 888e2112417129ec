"""PyTorch port, iresnet: the accuracy profile's embedder against the JAX
package's, and the port's 1-D inference BN.

Tolerances: at f32, rtol=1e-4 and atol=1e-4 (the two frameworks' conv
algorithms sum in different orders); at bf16 the frameworks round at
different places, so a cosine >= 0.99 per embedding. The seeded inits and the
BN folds are plain numpy and f32 elementwise work: equal, or within 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frp_tpu.models import nn as jnn
from frp_tpu.models.iresnet import init_iresnet as j_init
from frp_tpu.models.iresnet import iresnet_forward as j_fwd
from frp_tpu.models.params import load_params as jload
from frp_tpu.train.synthetic import make_scene

from frp_tpu_torch.models import nn as tnn
from frp_tpu_torch.models.iresnet import init_iresnet as t_init
from frp_tpu_torch.models.iresnet import iresnet_forward as t_fwd
from frp_tpu_torch.models.params import convert_params, flatten_params, load_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_params(tree).items()}


@pytest.mark.parametrize("variant", ["iresnet18", "iresnet34"])
def test_seeded_init_equals_jax(variant):
    want, got = _flat(j_init(3, variant=variant)), _flat(t_init(3, variant=variant))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("variant", ["iresnet18", "iresnet34", "iresnet50", "iresnet100"])
def test_init_key_paths_and_shapes_equal_jax(variant):
    want, got = _flat(j_init(0, variant=variant, embed_dim=64)), _flat(t_init(0, variant=variant, embed_dim=64))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert got["fc/w"].shape == (512 * 7 * 7, 64)


def test_unknown_variant_and_train_raise():
    """An unknown variant raises; the training forward (train=True), which
    raised before training was ported, returns the JAX package's embeddings
    and running stats for the same weights and input."""
    with pytest.raises(ValueError, match="unknown variant"):
        t_init(0, variant="iresnet9")
    tree = t_init(0)
    x = np.random.default_rng(4).normal(0, 0.5, (4, 112, 112, 3)).astype(np.float32)
    got, got_stats = t_fwd(convert_params(tree), torch.from_numpy(x), train=True)
    want, want_stats = j_fwd(tree, x, train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert set(got_stats) == set(want_stats) and ("stages", 3, 1, "bn2") in got_stats
    for path, st in want_stats.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(got_stats[path][k].numpy(), np.asarray(st[k]), **TOL)


@pytest.fixture(scope="module")
def shipped():
    path = os.path.join(REPO, "weights", "iresnet18.npz")
    return jload(path), convert_params(load_params(path))


def _crops(n=4, seed=21):
    """n rendered 112 x 112 faces, normalised as the engine's embed stage."""
    imgs = [make_scene(112, np.random.default_rng(seed + i), max_faces=1, portrait=True)[0]
            for i in range(n)]
    return (np.stack(imgs).astype(np.float32) - 127.5) / 128.0


def _cos(a, b):
    return np.sum(a * b, 1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_iresnet18_shipped_weights_match_jax(shipped, dtype):
    jp, tp = shipped
    x = _crops()
    want = np.asarray(jax.jit(j_fwd)(jp, jnp.asarray(x, dtype)))
    with torch.no_grad():
        got = t_fwd(tp, torch.from_numpy(x).to(getattr(torch, dtype))).numpy()
    assert got.shape == want.shape == (4, 128) and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    else:
        assert _cos(got, want).min() >= 0.99


def test_iresnet18_unnormalized_matches_jax(shipped):
    """normalize=False: the feature BN's output as it is."""
    jp, tp = shipped
    x = _crops(2, seed=40)
    want = np.asarray(jax.jit(lambda p, x: j_fwd(p, x, normalize=False))(jp, jnp.asarray(x)))
    with torch.no_grad():
        got = t_fwd(tp, torch.from_numpy(x), normalize=False).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _bn(c, seed):
    rng = np.random.default_rng(seed)
    return {"gamma": rng.uniform(0.5, 2.0, c).astype(np.float32),
            "beta": rng.normal(size=c).astype(np.float32),
            "mean": rng.normal(size=c).astype(np.float32),
            "var": rng.uniform(0.2, 3.0, c).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_1d_matches_jax(dtype):
    """A [B, D] input (iresnet's feat_bn): the fold is [D], not [D, 1, 1]."""
    p = _bn(128, 0)
    x = np.random.default_rng(1).normal(size=(5, 128)).astype(np.float32)
    want = np.asarray(jnn.batch_norm(p, jnp.asarray(x, dtype)).astype(jnp.float32))
    tp = convert_params(p)
    got = tnn.batch_norm(tp, torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.shape == (5, 128) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6 if dtype == "float32" else 1e-2,
                               atol=1e-6 if dtype == "float32" else 1e-2)


def test_batch_norm_4d_unchanged_and_folds_cached_per_rank():
    """An NCHW input folds to [C, 1, 1] as before; the 2-D and 4-D folds of
    one BN live side by side in its cache."""
    p = _bn(16, 2)
    x = np.random.default_rng(3).normal(size=(2, 6, 5, 16)).astype(np.float32)  # NHWC
    want = np.asarray(jnn.batch_norm(p, jnp.asarray(x)))
    tp = convert_params(p)
    got = tnn.batch_norm(tp, torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-6)
    flat = tnn.batch_norm(tp, torch.from_numpy(x[:, 0, 0]))
    np.testing.assert_allclose(flat.numpy(), want[:, 0, 0], rtol=1e-6, atol=1e-6)
    assert {k[1] for k in tp["_folded"]} == {2, 4}
    with pytest.raises(ValueError):
        tnn.batch_norm(tp, torch.zeros((2, 16, 3)))
