"""PyTorch port, a site's own weights: the ONNX and ``.pth`` importers, the
conv padding mode and the engine's ONNX candidates, on the CPU against the
JAX package (counterpart of tests/test_onnx_import.py,
tests/test_onnx_real_export.py and tests/test_onnx_torch_export.py).

- The same bytes through both packages' readers and importers give the same
  tensors and trees, leaf for leaf and bit for bit: tensor dumps, int32 and
  float16 initializers, numeric names in a shuffled order, BN folded into
  biased convs, det-style PReLU/Resize graphs, torchvision's SE layout,
  genuine torch.onnx and torch.save bytes.
- The port's forwards on imported trees equal JAX's at f32 under both
  padding modes (1e-4 of the output's scale).
- The engine's candidate order, the mixed-provenance warning and the
  padding switch with CONV_PADDING's precedence, as the JAX engine's.
- The iresnet50-512 ``embedder.onnx`` engine against the JAX engine at det
  128: valid, count and best_idx bit for bit, embeddings within 1e-4.

Both packages' padding modes are restored after each test (conftest.py
restores the JAX package's; a fixture here the port's).
"""

import copy
import logging
import os
import shutil
import types

import numpy as np
import pytest
import torch

from frp_tpu.config import load_config as j_load_config
from frp_tpu.engine.pipeline import RecognitionEngine as JEngine
from frp_tpu.models import iresnet as jires
from frp_tpu.models import mobilenetv3 as jmnv3
from frp_tpu.models import nn as jnn
from frp_tpu.models import params as jparams
from frp_tpu.models import retinaface as jret
from frp_tpu.train.synthetic import make_scene

from frp_tpu_torch.config import load_config
from frp_tpu_torch.engine.pipeline import RecognitionEngine, load_any
from frp_tpu_torch.models import iresnet as tires
from frp_tpu_torch.models import mobilenetv3 as tmnv3
from frp_tpu_torch.models import nn as tnn
from frp_tpu_torch.models import params as tparams
from frp_tpu_torch.models import retinaface as tret
from frp_tpu_torch.testing import onnx_export as ox

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = 1e-4  # f32 forwards: of the largest |output|


@pytest.fixture(autouse=True)
def _two_threads_and_port_padding():
    """Two intra-op threads a test (the suite runs files in parallel worker
    processes), and the port's padding mode restored afterwards."""
    n, mode = torch.get_num_threads(), tnn._PADDING_MODE
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    tnn._PADDING_MODE = mode


def _modes(monkeypatch, mode: str) -> None:
    """Both packages' global padding mode, restored by monkeypatch and the
    fixtures. JAX reads it when it traces: these forwards are not jitted."""
    monkeypatch.setattr(jnn, "_PADDING_MODE", mode)
    tnn.set_padding_mode(mode)


def _assert_trees_equal(a, b):
    fa, fb = tparams.flatten_params(a), tparams.flatten_params(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _assert_graphs_equal(a, b):
    assert a["nodes"] == b["nodes"]
    assert list(a["initializers"]) == list(b["initializers"])
    for k, v in a["initializers"].items():
        w = b["initializers"][k]
        assert v.dtype == w.dtype and v.shape == w.shape, k
        np.testing.assert_array_equal(v, w, err_msg=k)


# --- bytes ------------------------------------------------------------------------

def _tensor_dump(tensors: dict) -> bytes:
    """A node-free ONNX file of named float32 initializers."""
    graph = b"".join(ox._fld(5, 2, ox.tensor_proto(n, np.asarray(a, np.float32)))
                     for n, a in tensors.items())
    return ox._fld(1, 0, 8) + ox._fld(7, 2, graph)


def _unit_state(params, se_as_conv: bool = False, hwio: bool = False) -> dict:
    """torch-style names for a tree's units (m000.weight, ...); conv weights
    OIHW unless ``hwio``; SE dense layers as [1, 1, i, o] 1x1 convs (HWIO)
    when ``se_as_conv``, as torchvision stores them."""
    state = {}
    for idx, (kind, node, path) in enumerate(tparams._collect_units(params)):
        base = f"m{idx:03d}"
        if kind == "conv":
            w = np.asarray(node["w"])
            state[f"{base}.weight"] = w if hwio else w.transpose(3, 2, 0, 1)
        elif kind == "bn":
            for leaf, key in (("weight", "gamma"), ("bias", "beta"),
                              ("running_mean", "mean"), ("running_var", "var")):
                state[f"{base}.{leaf}"] = np.asarray(node[key])
        elif kind == "dense" and se_as_conv and "se" in path:
            state[f"{base}.weight"] = np.asarray(node["w"])[None, None]
            state[f"{base}.bias"] = np.asarray(node["b"])
        elif kind == "dense":
            state[f"{base}.weight"] = np.asarray(node["w"]).T
            state[f"{base}.bias"] = np.asarray(node["b"])
        elif kind == "prelu":
            state[f"{base}.weight"] = np.asarray(node["alpha"])
    return state


def _iresnet18(seed):
    return tires.init_iresnet(seed, variant="iresnet18", embed_dim=128)


def _case(name):
    """(bytes, init-tree factory) of one import case."""
    rng = np.random.default_rng
    if name == "iresnet_unfolded_numeric_shuffled":
        return (ox.iresnet_graph(_iresnet18(5), folded=False, shuffle_rng=rng(2)),
                lambda: _iresnet18(6))
    if name == "iresnet_folded_fp16":
        p = ox.realistic_stats(_iresnet18(3), rng(0))
        return (ox.iresnet_graph(p, folded=True, shuffle_rng=rng(11), fp16_rng=rng(13)),
                lambda: _iresnet18(9))
    if name == "det_prelu_fp16_resize":
        p = ox.realistic_stats(tret.init_retinaface(4, act="prelu"), rng(1))
        return (ox.retinaface_graph(p, shuffle_rng=rng(7), fp16_rng=rng(3)),
                lambda: tret.init_retinaface(8, act="prelu"))
    if name == "det_leaky_shipped":
        p = tparams.load_params(os.path.join(REPO, "weights", "retinaface_synthetic.npz"))
        return ox.retinaface_graph(p, shuffle_rng=rng(5)), lambda: tret.init_retinaface(0)
    if name == "mobilenetv3_torchvision_se":
        p = ox.realistic_stats(tmnv3.init_mobilenetv3_small(3), rng(0))
        return (ox.mobilenetv3_graph(p, shuffle_rng=rng(1), fp16_rng=rng(2)),
                lambda: tmnv3.init_mobilenetv3_small(9))
    if name == "mobilenetv3_tensor_dump":
        p = tmnv3.init_mobilenetv3_small(4)
        return _tensor_dump(_unit_state(p)), lambda: tmnv3.init_mobilenetv3_small(0)
    raise KeyError(name)


CASES = ["iresnet_unfolded_numeric_shuffled", "iresnet_folded_fp16", "det_prelu_fp16_resize",
         "det_leaky_shipped", "mobilenetv3_torchvision_se", "mobilenetv3_tensor_dump"]


# --- readers and importers ------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_importers_give_the_jax_tree_bit_for_bit(tmp_path, case):
    data, init = _case(case)
    path = str(tmp_path / "m.onnx")
    with open(path, "wb") as f:
        f.write(data)
    tg, jg = tparams.load_onnx_graph(path), jparams.load_onnx_graph(path)
    _assert_graphs_equal(tg, jg)
    tt, jt = tparams.load_onnx_tensors(path), jparams.load_onnx_tensors(path)
    assert tt.keys() == jt.keys()
    if "fp16" in case:
        assert np.dtype(np.float16) in {v.dtype for v in tt.values()}
    ours, theirs = init(), init()
    if tg["nodes"]:
        n = tparams.import_onnx_graph(ours, tg)
        assert n == jparams.import_onnx_graph(theirs, jg) and n > 100
    else:
        n = tparams.import_onnx_weights(ours, tt)
        assert n == jparams.import_onnx_weights(theirs, jt) and n > 100
    _assert_trees_equal(ours, theirs)
    # and the engine's loader gives that tree, which the structure check takes
    got = load_any(path, init())
    _assert_trees_equal(got, theirs)
    assert tparams.same_structure(init(), got)


def test_int32_initializer_and_garbage(tmp_path):
    """An int32 initializer (packed int32_data) parses beside the floats;
    missing, empty and garbage files read as None in both packages."""
    body = ox._fld(1, 0, 3) + ox._fld(2, 0, 6) + ox._fld(8, 2, b"shape_info")
    body += ox._fld(5, 2, b"".join(ox._varint(v) for v in (3, 1, 4)))
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    graph = ox._fld(5, 2, ox.tensor_proto("w", w)) + ox._fld(5, 2, body)
    path = tmp_path / "m.onnx"
    path.write_bytes(ox._fld(7, 2, graph))
    t, j = tparams.load_onnx_tensors(str(path)), jparams.load_onnx_tensors(str(path))
    assert t.keys() == j.keys() == {"w", "shape_info"}
    np.testing.assert_array_equal(t["w"], w)
    assert t["shape_info"].dtype == j["shape_info"].dtype == np.int32
    np.testing.assert_array_equal(t["shape_info"], [3, 1, 4])
    for name, data in (("empty.onnx", b""), ("garbage.onnx", b"\xff\xfe\x00not protobuf")):
        (tmp_path / name).write_bytes(data)
    for name in ("missing.onnx", "empty.onnx", "garbage.onnx"):
        for reader in (tparams.load_onnx_tensors, tparams.load_onnx_graph):
            assert reader(str(tmp_path / name)) is None


def test_writer_gives_the_jax_test_writers_bytes():
    """The port's writer and the JAX package's test-side writer give the
    same bytes, so the JAX graph tests' coverage holds for these files."""
    import tests.test_onnx_real_export as jw

    p = ox.realistic_stats(_iresnet18(5), np.random.default_rng(0))
    rng = np.random.default_rng
    for folded in (True, False):  # float16 leaves: the detector's below
        assert ox.iresnet_graph(p, folded, rng(2)) == jw._iresnet_graph(p, folded, rng(2))
    d = tret.init_retinaface(4, act="prelu")
    assert ox.retinaface_graph(d, rng(7), rng(3)) == jw._retinaface_graph(d, rng(7), rng(3))


def test_genuine_torch_exports_import_equal_jax(tmp_path):
    """Bytes that torch itself writes: a torch.onnx export (BN folded by the
    exporter) of an iresnet18 mirror, and a torch.save state dict of a
    MobileNetV3-Small mirror (torchvision's SE as 1x1 convs)."""
    from tests.test_onnx_torch_export import (
        _export,
        _IResNet,
        _MobileNetV3Small,
        _realistic_stats,
    )

    net = _IResNet().eval()
    _realistic_stats(net, np.random.default_rng(3))
    path = str(tmp_path / "w600k_r18.onnx")
    _export(net, path, fold=True)
    ours, theirs = _iresnet18(9), _iresnet18(9)
    assert tparams.import_onnx_graph(ours, tparams.load_onnx_graph(path)) == \
        jparams.import_onnx_graph(theirs, jparams.load_onnx_graph(path))
    _assert_trees_equal(ours, theirs)
    x = np.random.default_rng(4).normal(0, 1, (2, 112, 112, 3)).astype(np.float32)
    with torch.no_grad():
        ref = net(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
        tnn.set_padding_mode("torch")
        got = tires.iresnet_forward(tparams.convert_params(ours), torch.from_numpy(x),
                                    normalize=False).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)

    m = _MobileNetV3Small().eval()
    _realistic_stats(m, np.random.default_rng(6))
    pth = str(tmp_path / "deepfake_mobilenet.pth")
    torch.save(m.state_dict(), pth)
    ts, js = tparams.import_pth_state_dict(pth), jparams.import_pth_state_dict(pth)
    assert ts.keys() == js.keys() and len(ts) > 100
    for k in ts:
        np.testing.assert_array_equal(ts[k], js[k])
    ours, theirs = tmnv3.init_mobilenetv3_small(13), tmnv3.init_mobilenetv3_small(13)
    assert tparams.import_torch_weights(ours, ts) == jparams.import_torch_weights(theirs, js) > 150
    _assert_trees_equal(ours, theirs)
    (tmp_path / "empty.pth").write_bytes(b"")
    assert tparams.import_pth_state_dict(str(tmp_path / "empty.pth")) is None
    assert tparams.import_pth_state_dict(str(tmp_path / "missing.pth")) is None


def test_torchvision_se_state_dict_and_loud_mismatches(tmp_path):
    """A 1x1-conv SE weight lands on the dense unit as in JAX; a biased conv
    onto a bias-free unit, a shape mismatch and a graph of another depth
    raise in both packages."""
    p = tmnv3.init_mobilenetv3_small(0)
    state = _unit_state(p, se_as_conv=True, hwio=True)
    ours, theirs = tmnv3.init_mobilenetv3_small(1), tmnv3.init_mobilenetv3_small(1)
    assert tparams.import_torch_weights(ours, dict(state)) == \
        jparams.import_torch_weights(theirs, dict(state))
    _assert_trees_equal(ours, theirs)
    _assert_trees_equal(ours, p)

    conv = {"stem": tnn.conv_init(np.random.default_rng(0), 3, 3, 3, 8)}
    biased = {"stem.weight": np.zeros((3, 3, 3, 8), np.float32),
              "stem.bias": np.zeros((8,), np.float32)}
    for mod in (tparams, jparams):
        with pytest.raises(ValueError, match="bias"):
            mod.import_torch_weights(copy.deepcopy(conv), biased)
        with pytest.raises(ValueError, match="shape mismatch"):
            mod.import_onnx_weights({"head": {"w": np.zeros((8, 4), np.float32),
                                              "b": np.zeros(4, np.float32)}},
                                    {"fc.weight": np.zeros((4, 9), np.float32),
                                     "fc.bias": np.zeros(4, np.float32)})
    path = str(tmp_path / "emb.onnx")
    _write(path, ox.iresnet_graph(_iresnet18(5), folded=True))
    wrong = tires.init_iresnet(5, variant="iresnet34", embed_dim=128)
    for mod in (tparams, jparams):
        with pytest.raises(ValueError, match="mismatch"):
            mod.import_onnx_graph(copy.deepcopy(wrong), mod.load_onnx_graph(path))
    with pytest.raises(ValueError, match="mismatch"):
        load_any(path, wrong)


# --- forwards under both padding modes ---------------------------------------------

def test_torch_padding_keeps_stride2_shapes(monkeypatch):
    """A stride-2 3x3 conv on an even input gives the same output shape
    under both modes, and other values: "same" pads (0, 1), "torch" (1, 1)."""
    p = tparams.convert_params(tnn.conv_init(np.random.default_rng(0), 3, 3, 4, 8))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 4, 16, 16)).astype(np.float32))
    outs = {}
    for mode in ("same", "torch"):
        _modes(monkeypatch, mode)
        outs[mode] = tnn.conv(p, x, stride=2)
        assert outs[mode].shape == (1, 8, 8, 8)
    assert not torch.allclose(outs["same"], outs["torch"])
    w = p["w"]
    torch.testing.assert_close(outs["torch"], torch.nn.functional.conv2d(x, w, None, 2, 1),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        tnn.set_padding_mode("valid")


def _forward_case(name, tmp_path):
    """(port forward, JAX forward, imported numpy tree, input) of a model
    family, its tree imported from that family's ONNX replica."""
    rng = np.random.default_rng
    if name == "iresnet18":
        data, init = _case("iresnet_folded_fp16")
        fwds = (lambda p, x: tires.iresnet_forward(p, x, normalize=False),
                lambda p, x: jires.iresnet_forward(p, x, normalize=False))
        shape = (2, 112, 112, 3)
    elif name == "retinaface_prelu":
        data, init = _case("det_prelu_fp16_resize")
        fwds = (lambda p, x: tret.retinaface_forward(p, x)["ldm"],
                lambda p, x: jret.retinaface_forward(p, x)["ldm"])
        shape = (1, 128, 128, 3)
    else:
        data, init = _case("mobilenetv3_torchvision_se")
        fwds = (tmnv3.mobilenetv3_forward, jmnv3.mobilenetv3_forward)
        shape = (2, 112, 112, 3)
    path = str(tmp_path / "m.onnx")
    _write(path, data)
    return fwds, load_any(path, init()), rng(4).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("mode", ["same", "torch"])
@pytest.mark.parametrize("model", ["iresnet18", "retinaface_prelu", "mobilenetv3"])
def test_imported_forward_equals_jax(tmp_path, monkeypatch, model, mode):
    (tf, jf), tree, x = _forward_case(model, tmp_path)
    _modes(monkeypatch, mode)
    with torch.no_grad():
        got = tf(tparams.convert_params(tree), torch.from_numpy(x)).numpy()
    want = np.asarray(jf(tree, x))
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL * scale)


# --- the engine's candidates and padding switch -------------------------------------

def _shim(wd):
    return types.SimpleNamespace(cfg=types.SimpleNamespace(weights_dir=str(wd)))


def _write(path, data: bytes):
    with open(path, "wb") as f:
        f.write(data)


def _all_onnx_dir(wd):
    """retinaface.onnx, embedder.onnx (iresnet18) and spoof.onnx."""
    wd.mkdir(exist_ok=True)
    rng = np.random.default_rng
    _write(wd / "retinaface.onnx", ox.retinaface_graph(tret.init_retinaface(3), rng(1)))
    _write(wd / "embedder.onnx", ox.iresnet_graph(_iresnet18(4), True, rng(2)))
    _write(wd / "spoof.onnx", ox.mobilenetv3_graph(tmnv3.init_mobilenetv3_small(5), rng(3)))
    return wd


def _init_trees():
    return {"detector": tret.init_retinaface(0), "embedder": _iresnet18(1),
            "spoof": tmnv3.init_mobilenetv3_small(2)}


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def engine_warnings():
    h = _Records()
    log = logging.getLogger("frp.engine")
    log.addHandler(h)
    yield h.messages
    log.removeHandler(h)


def test_user_onnx_outranks_shipped_npz(tmp_path, monkeypatch):
    """A spoof.onnx beside the shipped-style spoof.npz wins, in both
    engines, with the same tree."""
    monkeypatch.delenv("CONV_PADDING", raising=False)
    params = tmnv3.init_mobilenetv3_small(0)
    tparams.save_params(str(tmp_path / "spoof.npz"), params)
    _write(tmp_path / "spoof.onnx", ox.mobilenetv3_graph(
        ox.realistic_stats(tmnv3.init_mobilenetv3_small(7), np.random.default_rng(1))))
    t_trees, j_trees = {"spoof": params}, {"spoof": jmnv3.init_mobilenetv3_small(0)}
    t_loaded = RecognitionEngine._load_weights(_shim(tmp_path), t_trees, "mobilefacenet")
    j_loaded = JEngine._load_weights(_shim(tmp_path), j_trees, "mobilefacenet")
    assert t_loaded["spoof"] == j_loaded["spoof"] == str(tmp_path / "spoof.onnx")
    _assert_trees_equal(t_trees["spoof"], j_trees["spoof"])
    # a lone ONNX model: the switch to "torch" as in the JAX engine
    assert tnn._PADDING_MODE == jnn._PADDING_MODE == "torch"


def test_all_onnx_switches_padding_mixed_keeps_it(tmp_path, monkeypatch, engine_warnings):
    monkeypatch.delenv("CONV_PADDING", raising=False)
    wd = _all_onnx_dir(tmp_path / "onnx")
    for eng_cls, mod in ((RecognitionEngine, tnn), (JEngine, jnn)):
        monkeypatch.setattr(mod, "_PADDING_MODE", "same")
        trees = _init_trees()
        loaded = eng_cls._load_weights(_shim(wd), trees, "iresnet18")
        assert all(p.endswith(".onnx") for p in loaded.values()), loaded
        assert mod._PADDING_MODE == "torch"
    switched = [m for m in engine_warnings if "switching conv padding to 'torch'" in m]
    assert len(switched) == 2, engine_warnings

    # mixed: the embedder from ONNX, the detector and spoof from npz
    mixed = tmp_path / "mixed"
    mixed.mkdir()
    shutil.copy(wd / "embedder.onnx", mixed / "embedder.onnx")
    for name in ("retinaface_synthetic.npz", "spoof.npz"):
        shutil.copy(os.path.join(REPO, "weights", name), mixed / name)
    engine_warnings.clear()
    for eng_cls, mod in ((RecognitionEngine, tnn), (JEngine, jnn)):
        monkeypatch.setattr(mod, "_PADDING_MODE", "same")
        loaded = eng_cls._load_weights(_shim(mixed), _init_trees(), "iresnet18")
        assert loaded["embedder"].endswith("embedder.onnx")
        assert loaded["detector"].endswith("retinaface_synthetic.npz")
        assert mod._PADDING_MODE == "same"
    mixed_msgs = [m for m in engine_warnings if "mixed weight provenance" in m]
    assert len(mixed_msgs) == 2 and mixed_msgs[0] == mixed_msgs[1], engine_warnings
    assert "'same'" in mixed_msgs[0]


def test_conv_padding_env_wins(tmp_path, monkeypatch, engine_warnings):
    wd = _all_onnx_dir(tmp_path / "onnx")
    monkeypatch.setenv("CONV_PADDING", "same")
    for eng_cls, mod in ((RecognitionEngine, tnn), (JEngine, jnn)):
        monkeypatch.setattr(mod, "_PADDING_MODE", "same")
        eng_cls._load_weights(_shim(wd), _init_trees(), "iresnet18")
        assert mod._PADDING_MODE == "same"
    assert not [m for m in engine_warnings if "padding" in m]


# --- the iresnet50-512 embedder.onnx engine ---------------------------------------

DET = 128
KW = dict(det_size=DET, max_faces_per_frame=2, pre_nms_topk=64, det_conf_threshold=0.3,
          compute_dtype="float32", embedder_arch="iresnet50", embed_dim=512)


def test_iresnet50_512_onnx_engine_equals_jax(tmp_path, monkeypatch, engine_warnings):
    """A w600k-style embedder.onnx (iresnet50, 512-d) beside
    the shipped detector and spoof npz: the mixed case, so "same" padding
    stays. Both engines import it, serve two portrait scenes alike, and an
    enrolled face then matches."""
    monkeypatch.delenv("CONV_PADDING", raising=False)
    monkeypatch.setattr(jnn, "_PADDING_MODE", "same")
    tnn.set_padding_mode("same")
    for name in ("retinaface_synthetic.npz", "spoof.npz"):
        shutil.copy(os.path.join(REPO, "weights", name), tmp_path / name)
    # float32 leaves: the JAX reader decodes int32_data value by value, and
    # the float16 encodings are held above at iresnet18's size
    _write(tmp_path / "embedder.onnx", ox.w600k_style(seed=12, fp16=False))
    teng = RecognitionEngine(load_config(**KW, weights_dir=str(tmp_path)), device="cpu")
    jeng = JEngine(j_load_config(**KW, weights_dir=str(tmp_path)), seed=0)
    for eng in (teng, jeng):
        assert eng.weights_loaded["embedder"] == str(tmp_path / "embedder.onnx")
        assert eng.weights_loaded["detector"].endswith(".npz")
        assert eng.distance_scale == 1.0  # no calibration for a user's export
    assert tnn._PADDING_MODE == jnn._PADDING_MODE == "same"
    assert any("mixed weight provenance" in m for m in engine_warnings)

    frames = np.stack([make_scene(DET, np.random.default_rng(s), max_faces=1, portrait=True)[0]
                       for s in (5, 3)])
    first = teng.process_frames(frames)
    assert first["valid"].any(), "the shipped detector missed the portrait scenes"
    embs = first["embeddings"][first["valid"]]
    assert embs.shape[1] == 512
    # each face at its own norm, and decoys: no rounding ties in best_idx
    embs = embs * np.linspace(1.0, 0.8, len(embs), dtype=np.float32)[:, None]
    decoys = np.random.default_rng(0).normal(size=(3, 512)).astype(np.float32)
    for eng in (teng, jeng):
        for n, e in enumerate([*embs, *decoys]):
            eng.gallery.add(f"id{n}", e)
    got, want = teng.process_frames(frames), jeng.process_frames(frames)
    for key in ("valid", "count", "best_idx", "is_match"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    v = want["valid"]
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], atol=1e-2)
    scale = float(np.abs(want["embeddings"][v]).max())
    np.testing.assert_allclose(got["embeddings"][v], want["embeddings"][v], rtol=0,
                               atol=FWD_TOL * scale)
    # a self-match's distance is the square root of f32 rounding (~1e-3)
    np.testing.assert_allclose(got["best_distance"][v], want["best_distance"][v], atol=2e-3)
    i, j = np.argwhere(v)[0]
    assert got["is_match"][i, j] and got["gallery_names"][got["best_idx"][i, j]] == "id0"
