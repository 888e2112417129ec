"""PyTorch port, host side: the port's copies of host-only code equal the
JAX package's (config, anchors, batching, synthetic scenes, parameter
files), the port imports nothing of JAX, and the kernel wrappers keep the
launch rule (plain version only for CPU tensors, no fallback)."""

import ast
import dataclasses
import inspect
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import frp_tpu.config as jcfg
from frp_tpu.engine import batching as jbatch
from frp_tpu.models import mobilefacenet as jmfn
from frp_tpu.models import mobilenetv3 as jmnv3
from frp_tpu.models import retinaface as jret
from frp_tpu.models.params import load_params as jload_params
from frp_tpu.ops.anchors import generate_anchors as jgenerate_anchors
from frp_tpu.train import synthetic as jsyn
from frp_tpu.utils.fingerprint import weights_fingerprint as jfingerprint

import frp_tpu_torch.config as tcfg
from frp_tpu_torch.engine import batching as tbatch
from frp_tpu_torch.models import mobilefacenet as tmfn
from frp_tpu_torch.models import mobilenetv3 as tmnv3
from frp_tpu_torch.models import retinaface as tret
from frp_tpu_torch.models.params import convert_params, flatten_params, load_params
from frp_tpu_torch.ops import align_cuda, detection_cuda, nms_cuda
from frp_tpu_torch.ops.anchors import generate_anchors
from frp_tpu_torch.testing import synthetic as tsyn
from frp_tpu_torch.utils.fingerprint import weights_fingerprint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = ["retinaface_synthetic.npz", "mobilefacenet.npz", "spoof.npz"]


# --- host copies -----------------------------------------------------------

def test_config_defaults_and_env_map_equal():
    assert dataclasses.asdict(tcfg.Config()) == dataclasses.asdict(jcfg.Config())
    assert tcfg._ENV_MAP == jcfg._ENV_MAP
    assert tcfg.PROFILES == jcfg.PROFILES
    assert tcfg.ENV_EXEMPT == jcfg.ENV_EXEMPT


def test_load_config_reads_env_like_jax(monkeypatch):
    monkeypatch.setenv("DET_SIZE", "320")
    monkeypatch.setenv("MAX_FACES", "8")
    monkeypatch.setenv("COMPUTE_DTYPE", "float32")
    monkeypatch.setenv("SMTP_SERVER", "mail.example")
    got, want = tcfg.load_config(pre_nms_topk=128), jcfg.load_config(pre_nms_topk=128)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.det_size, got.smtp_host) == (320, "mail.example")


@pytest.mark.parametrize("size", [100, 128, 640])
def test_anchors_bit_equal(size):
    a, b = generate_anchors(size), jgenerate_anchors(size)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _i420_stream(rng, b=2, rows=96, size=128, n=6):
    """I420 batches: a keyframe, small moving patches, one full change and
    one repeat (exercises the raw/delta decisions and the ladder rungs)."""
    base = rng.integers(0, 255, (b, rows * 3 // 2, size), dtype=np.uint8)
    seq = [base]
    for t in range(1, n):
        cur = seq[-1].copy()
        if t == 3:
            cur = rng.integers(0, 255, cur.shape, dtype=np.uint8)  # full change
        elif t == 4:
            pass  # unchanged
        else:
            h = 4 * t
            cur[:, 10 * t : 10 * t + h, 8 : 8 + 16 * t] = rng.integers(0, 255, dtype=np.uint8)
        seq.append(cur)
    return seq


@pytest.mark.parametrize("hinted", [False, True])
def test_delta_encoder_payloads_equal(hinted):
    seq = _i420_stream(np.random.default_rng(3))
    ej, et = jbatch.DeltaEncoder(block_bytes=128), tbatch.DeltaEncoder(block_bytes=128)
    kinds = []
    for batch in seq:
        hints = [None, [(0, 40)]] if hinted else None
        pj, pt = ej.encode(batch, hints=hints), et.encode(batch, hints=hints)
        kinds.append(pt[0])
        assert pj[0] == pt[0]
        assert pt.seq == pj.seq
        for x, y in zip(pj[1:], pt[1:]):
            assert x.dtype == y.dtype and x.shape == y.shape  # ladder rung
            np.testing.assert_array_equal(x, y)
    assert "raw" in kinds[1:] and "delta" in kinds


def test_apply_host_equal():
    rng = np.random.default_rng(0)
    prev = rng.integers(0, 255, (2, 1024), dtype=np.uint8)
    idx = np.array([[3, -1, 0], [7, 1, -1]], np.int32)
    blocks = rng.integers(0, 255, (2, 3, 128), dtype=np.uint8)
    np.testing.assert_array_equal(
        tbatch.DeltaEncoder.apply_host(prev, idx, blocks),
        jbatch.DeltaEncoder.apply_host(prev, idx, blocks))


@pytest.mark.parametrize("shape,rows", [((90, 160, 3), None), ((90, 160, 3), 80), ((200, 120, 3), None)])
def test_letterbox_and_active_rows_equal(shape, rows):
    frame = np.random.default_rng(1).integers(0, 255, shape, dtype=np.uint8)
    a, sa, oa = tbatch.letterbox(frame, 128, rows=rows)
    b, sb, ob = jbatch.letterbox(frame, 128, rows=rows)
    np.testing.assert_array_equal(a, b)
    assert (sa, oa) == (sb, ob)
    shapes = [shape[:2], (1080, 1920), (480, 640)]
    assert tbatch.active_rows_for(shapes, 640) == jbatch.active_rows_for(shapes, 640)
    assert tbatch.active_rows_for([(1080, 1920)], 640) == jbatch.active_rows_for([(1080, 1920)], 640)


@pytest.mark.parametrize("seed,portrait", [(0, False), (5, True), (11, False)])
def test_make_scene_equal(seed, portrait):
    a = tsyn.make_scene(128, np.random.default_rng(seed), max_faces=3, portrait=portrait)
    b = jsyn.make_scene(128, np.random.default_rng(seed), max_faces=3, portrait=portrait)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# --- parameter files -------------------------------------------------------

@pytest.mark.parametrize("name", WEIGHTS)
def test_npz_paths_shapes_values_equal(name):
    path = os.path.join(REPO, "weights", name)
    port = flatten_params(load_params(path))
    ref_tree = jax.device_get(jload_params(path))
    ref = flatten_params(ref_tree)
    assert len(ref) == len(jax.tree_util.tree_leaves(ref_tree)) == len(port)
    assert port.keys() == ref.keys()
    for k in ref:
        assert port[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(port[k], ref[k])
    assert weights_fingerprint(path) == jfingerprint(path)


@pytest.mark.parametrize("model", ["retinaface", "retinaface_prelu", "mobilefacenet", "mobilenetv3"])
def test_seeded_init_equals_jax(model):
    port, ref = {
        "retinaface": (tret.init_retinaface(3), jret.init_retinaface(3)),
        "retinaface_prelu": (tret.init_retinaface(3, act="prelu"),
                             jret.init_retinaface(3, act="prelu")),
        "mobilefacenet": (tmfn.init_mobilefacenet(4), jmfn.init_mobilefacenet(4)),
        "mobilenetv3": (tmnv3.init_mobilenetv3_small(5), jmnv3.init_mobilenetv3_small(5)),
    }[model]
    a, b = flatten_params(port), flatten_params(ref)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], np.asarray(b[k]))


def test_convert_params_layouts():
    tree = {
        "conv": {"w": np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)},
        "fc": {"w": np.ones((6, 7), np.float32), "b": np.zeros(7, np.float32)},
        "bn": {"gamma": np.ones(5, np.float32)},
        "blocks": [None, {"alpha": np.full(3, 0.25, np.float32)}],
    }
    out = convert_params(tree)
    assert tuple(out["conv"]["w"].shape) == (5, 4, 2, 3)  # HWIO -> OIHW
    assert out["conv"]["w"][4, 3, 1, 2] == tree["conv"]["w"][1, 2, 3, 4]
    assert tuple(out["fc"]["w"].shape) == (7, 6)
    assert out["blocks"][0] is None and out["blocks"][1]["alpha"].dtype == torch.float32


# --- isolation and the launch rule ----------------------------------------

def test_port_imports_no_jax_nor_frp_tpu():
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import frp_tpu_torch\n"
        "for m in pkgutil.walk_packages(frp_tpu_torch.__path__, 'frp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'frp_tpu')]\n"
        "mods = [n for n in sys.modules if n.startswith('frp_tpu_torch.')]\n"
        "print(len(mods), bad)\n"
        "assert not bad, bad\n"
        # the serving platform's subpackages are among what was imported
        "for sub in ('api', 'api.routes', 'platform', 'utils'):\n"
        "    assert [n for n in mods if n.startswith('frp_tpu_torch.' + sub + '.')], sub\n"
        "for n in ('api.main', 'api.http', 'api.socketio', 'api.routes.camera',\n"
        "          'api.routes.face', 'api.routes.alerts', 'platform.context',\n"
        "          'platform.face_service', 'platform.state', 'platform.tracking',\n"
        "          'platform.alerts', 'platform.health', 'platform.schemas',\n"
        "          'platform.dbops', 'utils.docstore', 'utils.crypto',\n"
        "          'utils.thumbnail_cache', 'utils.profiling', 'utils.logger',\n"
        "          'train.arcface', 'train.classifier', 'train.detector', 'train.checkpoint',\n"
        "          'train.synthetic', 'train.pairs', 'ops.anchor_targets', 'tools.fl_client',\n"
        "          'tools.pretrain_embedder', 'tools.pretrain_spoof', 'tools.pretrain_synthetic',\n"
        "          'tools.import_real_weights', 'tools.calibrate_embedder', 'tools.tiered_eval',\n"
        "          'tools.eval_spoof', 'tools.migrate_retinaface_npz', 'tools.demo_server',\n"
        "          'tools.mock_camera_worker', 'testing.onnx_export'):\n"
        "    assert 'frp_tpu_torch.' + n in mods, n\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 45


def test_plain_path_launches_nothing_and_wrappers_never_fall_back():
    for mod in (detection_cuda, align_cuda, nms_cuda):
        mod.LAUNCHES = 0
    rng = np.random.default_rng(0)
    pay = np.zeros((1, 8, 19), np.float32)
    pay[..., 16:18] = 0.1
    pay[..., 18] = np.linspace(0.9, 0.1, 8)
    detection_cuda.fused_head(torch.from_numpy(pay), 4, 0.5, 0.4, 0.5, 128.0)
    align_cuda.warp_crops(
        torch.from_numpy(rng.integers(0, 255, (1, 32, 32, 3), dtype=np.uint8)),
        torch.tensor([[[[1.0, 0, 0], [0, 1.0, 0]]]]), 8)
    nms_cuda.greedy_suppress(torch.rand(1, 8, 8), torch.ones(1, 8, dtype=torch.bool))
    assert (detection_cuda.LAUNCHES, align_cuda.LAUNCHES, nms_cuda.LAUNCHES) == (0, 0, 0)
    # no try/except anywhere in the wrapper modules: a kernel that fails to
    # build or launch raises, it never falls back to the plain version
    for mod in (detection_cuda, align_cuda, nms_cuda):
        tree = ast.parse(inspect.getsource(mod))
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], mod.__name__
    # the kernel entries refuse CPU tensors instead of computing anything
    with pytest.raises(ValueError):
        detection_cuda.fused_head_kernel(torch.from_numpy(pay), 4, 0.5, 0.4, 0.5, 128.0)
    with pytest.raises(ValueError):
        align_cuda.warp_crops_kernel(torch.zeros(1, 8, 8, 3, dtype=torch.uint8), torch.zeros(1, 1, 2, 3), 4)
    with pytest.raises(ValueError):
        nms_cuda.greedy_suppress_kernel(torch.rand(1, 8, 8), torch.ones(1, 8, dtype=torch.bool))
    assert (detection_cuda.LAUNCHES, align_cuda.LAUNCHES, nms_cuda.LAUNCHES) == (0, 0, 0)
