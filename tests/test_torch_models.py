"""PyTorch port, models: RetinaFace, MobileFaceNet and MobileNetV3 forwards
equal the JAX package's on the shipped weights (carried across by
``convert_params``) and rendered scenes.

Tolerances: at f32, rtol=1e-4 and atol=1e-4 — the two frameworks' conv
algorithms sum in different orders. At bf16 the frameworks round at
different places (e.g. a scalar multiplier is rounded to bf16 first in JAX),
so only shapes and a cosine >= 0.99 are checked.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frp_tpu.models.mobilefacenet import mobilefacenet_forward as j_mfn
from frp_tpu.models.mobilenetv3 import mobilenetv3_forward as j_mnv3
from frp_tpu.models.params import load_params as jload
from frp_tpu.models.retinaface import retinaface_forward as j_ret
from frp_tpu.train.synthetic import make_scene

from frp_tpu_torch.models import nn as tnn
from frp_tpu_torch.models.mobilefacenet import mobilefacenet_forward as t_mfn
from frp_tpu_torch.models.mobilenetv3 import mobilenetv3_forward as t_mnv3
from frp_tpu_torch.models.params import convert_params, load_params
from frp_tpu_torch.models.retinaface import retinaface_forward as t_ret

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)


def _weights(name):
    path = os.path.join(REPO, "weights", name)
    return jload(path), convert_params(load_params(path))


def _scenes(size, n, seed=0):
    imgs = [make_scene(size, np.random.default_rng(seed + i), max_faces=2,
                       portrait=i % 2 == 0)[0] for i in range(n)]
    return np.stack(imgs).astype(np.float32)


def _cos(a, b):
    a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
    return np.sum(a * b, 1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


@pytest.fixture(scope="module")
def detector():
    return _weights("retinaface_synthetic.npz")


# 100 px: the FPN upsamples 4->7 and 7->13, not an exact 2x, pinning the
# half-pixel nearest rule; stride-2 convs on even inputs pin XLA SAME's
# (0, 1) padding at every size
@pytest.mark.parametrize("size", [128, 100])
def test_retinaface_f32_matches_jax(detector, size):
    jp, tp = detector
    x = (_scenes(size, 2) - 127.5) / 128.0
    want = jax.device_get(jax.jit(j_ret)(jp, jnp.asarray(x)))
    with torch.no_grad():
        got = t_ret(tp, torch.from_numpy(x))
    for key in ("loc", "ldm", "score", "cls_logits"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), want[key], err_msg=key, **TOL)


def test_retinaface_bf16_cosine(detector):
    jp, tp = detector
    x = (_scenes(128, 2, seed=3) - 127.5) / 128.0
    want = jax.device_get(jax.jit(j_ret)(jp, jnp.asarray(x, jnp.bfloat16)))
    with torch.no_grad():
        got = t_ret(tp, torch.from_numpy(x).to(torch.bfloat16))
    for key in ("loc", "ldm", "cls_logits"):
        assert got[key].dtype == torch.float32 and got[key].shape == want[key].shape
        assert _cos(got[key].numpy(), want[key]).min() >= 0.99, key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mobilefacenet_matches_jax(dtype):
    jp, tp = _weights("mobilefacenet.npz")
    x = (_scenes(112, 4, seed=7) - 127.5) / 128.0
    want = np.asarray(jax.jit(j_mfn)(jp, jnp.asarray(x, dtype)))
    with torch.no_grad():
        got = t_mfn(tp, torch.from_numpy(x).to(getattr(torch, dtype))).numpy()
    assert got.shape == want.shape == (4, 128) and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert _cos(got, want).min() >= 0.99


def test_mobilenetv3_f32_matches_jax():
    jp, tp = _weights("spoof.npz")
    mean = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
    std = np.array([0.229, 0.224, 0.225], np.float32) * 255.0
    x = (_scenes(112, 4, seed=11) - mean) / std
    want = np.asarray(jax.jit(j_mnv3)(jp, jnp.asarray(x)))
    with torch.no_grad():
        got = t_mnv3(tp, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 2)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n,k,s", [(8, 3, 2), (7, 3, 2), (8, 1, 1), (7, 5, 2)])
def test_same_padding_matches_xla(n, k, s):
    from jax import lax

    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, n, n, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 4)).astype(np.float32)
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (s, s), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    p = convert_params({"w": w})
    got = tnn.conv(p, torch.from_numpy(x).permute(0, 3, 1, 2), stride=s)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5)
