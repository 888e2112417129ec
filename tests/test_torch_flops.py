"""PyTorch port, FLOP and MFU accounting (``frp_tpu_torch/utils/flops.py``)
on the CPU against ``frp_tpu/utils/flops.py``.

The two counters differ by design: the JAX package prices the compiled
program with XLA's cost analysis, which counts element-wise ops too; the
port counts the matmuls and convolutions that FlopCounterMode sees. The gaps
held here were measured on this suite's engines (det 128, 4 slots, batch 2,
f32, the shipped weights):
- embed (MobileFaceNet + spoof): XLA 3.1 % above (3.909 against 3.790
  GFLOP), the element-wise ops of the PReLUs and BNs;
- detect (RetinaFace): XLA 3.0 % below (0.1523 against 0.1570 GFLOP); its
  count of the strided and FPN convolutions differs from FlopCounterMode's;
- match: the port counts the distance matmul alone, 2 n D G (n = 8 slots,
  D = 128, a 128-row gallery: 262,144); XLA adds the norms, the subtraction
  and the top-k compares, 19.5 % more;
- crop: the port counts none (the warp is a gather, quality element-wise),
  XLA 12.5 MFLOP of element-wise work.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frp_tpu.config import load_config as j_load_config
from frp_tpu.engine.pipeline import RecognitionEngine as JEngine
from frp_tpu.utils import flops as jflops

from frp_tpu_torch.config import load_config
from frp_tpu_torch.engine.pipeline import RecognitionEngine, embed_compact_rungs
from frp_tpu_torch.utils import flops as tflops

KW = dict(det_size=128, max_faces_per_frame=4, pre_nms_topk=64,
          det_conf_threshold=0.3, compute_dtype="float32")


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs its files in parallel worker processes: two intra-op
    threads a test keep those from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("out_hw,kh,kw,cin,cout,groups", [
    ((56, 56), 3, 3, 64, 64, 1), ((7, 7), 7, 7, 512, 512, 512), ((1, 1), 1, 1, 3, 8, 1),
    ((28, 14), 3, 1, 16, 32, 4)])
def test_conv_flops_equals_jax(out_hw, kh, kw, cin, cout, groups):
    got = tflops.conv_flops(out_hw, kh, kw, cin, cout, groups)
    assert got == jflops.conv_flops(out_hw, kh, kw, cin, cout, groups)
    assert got == 2.0 * out_hw[0] * out_hw[1] * kh * kw * (cin // groups) * cout


@pytest.mark.parametrize("cin,cout", [(512, 128), (1, 1), (128, 10)])
def test_dense_flops_equals_jax(cin, cout):
    assert tflops.dense_flops(cin, cout) == jflops.dense_flops(cin, cout) == 2.0 * cin * cout


@pytest.mark.parametrize("m,n,k", [(64, 32, 16), (1, 128, 512), (7, 5, 3)])
def test_counted_flops_of_a_matmul_is_2mnk_as_jax(m, n, k):
    a, b = np.ones((m, k), np.float32), np.ones((k, n), np.float32)
    got = tflops.counted_flops(torch.matmul, torch.from_numpy(a), torch.from_numpy(b))
    want = jflops.compiled_flops(jax.jit(jnp.dot), jnp.asarray(a), jnp.asarray(b))
    assert got == want == 2.0 * m * n * k


def test_counted_flops_counts_the_backward():
    w = torch.ones((16, 8), requires_grad=True)
    x = torch.ones((4, 16))

    def step():
        (x @ w).sum().backward()

    # the forward's product, and the backward's product for w's gradient
    assert tflops.counted_flops(step) == 2 * (2.0 * 4 * 16 * 8)


@pytest.fixture(scope="module")
def engines():
    return {spoof: (JEngine(j_load_config(**KW), seed=0, with_spoof=spoof),
                    RecognitionEngine(load_config(**KW), device="cpu", with_spoof=spoof))
            for spoof in (True, False)}


@pytest.mark.parametrize("spoof", [True, False])
def test_engine_stage_flops_agrees_with_jax_within_the_counters_gap(engines, spoof):
    jeng, teng = engines[spoof]
    want = jflops.engine_stage_flops(jeng, 2)
    got = tflops.engine_stage_flops(teng, 2)
    assert set(got) == set(want) == {"detect", "crop", "embed", "match", "total"}
    assert want["embed"] / got["embed"] == pytest.approx(1.031, abs=0.01)  # measured 1.0313, 1.0318
    assert want["detect"] / got["detect"] == pytest.approx(0.970, abs=0.01)  # measured 0.9701
    n, d, g = 2 * KW["max_faces_per_frame"], teng.cfg.embed_dim, teng.gallery.capacity
    assert got["match"] == 2.0 * n * d * g
    assert 1.0 < want["match"] / got["match"] < 1.25  # measured 1.195
    assert got["crop"] == 0.0 and want["crop"] > 0
    assert got["total"] == sum(got[k] for k in ("detect", "crop", "embed", "match"))


def test_engine_stage_flops_without_spoof_drops_the_spoof_net(engines):
    with_spoof = tflops.engine_stage_flops(engines[True][1], 2)
    without = tflops.engine_stage_flops(engines[False][1], 2)
    assert without["detect"] == with_spoof["detect"] and without["match"] == with_spoof["match"]
    # MobileNetV3-small on 8 crops of 112: some 30 MFLOP a crop
    assert 0.1e9 < with_spoof["embed"] - without["embed"] < 0.5e9


def test_occupancy_scales_the_embed_by_the_rung(engines):
    teng = engines[True][1]
    batch = 16  # 64 slots: compaction's smallest batch
    n = batch * KW["max_faces_per_frame"]
    rungs = embed_compact_rungs(n)
    assert rungs == [8, 32, 52]
    plain = tflops.engine_stage_flops(teng, batch)
    for occupancy, rung in ((8, 8), (40, 52), (60, 64)):
        got = tflops.engine_stage_flops(teng, batch, occupancy=occupancy)
        assert got["embed"] == pytest.approx(plain["embed"] * rung / n, rel=1e-12)
        assert got["detect"] == plain["detect"] and got["match"] == plain["match"]


def test_mfu_is_linear_in_time_and_zero_without_flops():
    assert tflops.PEAK_FLOPS_BF16 == 989e12
    assert tflops.mfu(989e12, 1.0) == 1.0
    assert tflops.mfu(1e12, 0.5) == pytest.approx(2 * tflops.mfu(1e12, 1.0), rel=1e-15)
    assert tflops.mfu(1e12, 1.0, peak=1e12) == jflops.mfu(1e12, 1.0, peak=1e12) == 1.0
    for flops, seconds in ((0.0, 1.0), (None, 1.0), (1e12, 0.0), (1e12, -1.0)):
        assert tflops.mfu(flops, seconds) == jflops.mfu(flops, seconds) == 0.0
