"""PyTorch port, the weights tools on the CPU against the JAX package's
``tools/`` scripts (counterpart of tests/test_import_real_weights.py):

- ``import_real_weights``: ``--dry-run`` on a genuine torch.onnx export; a
  wrong arch, a garbage file and a 512-d embedder (the reference's 128-d
  validation) exit loudly; install and re-measure against a temporary
  repository root, never the real ``weights/``.
- ``calibrate_embedder``, ``tiered_eval`` and ``eval_spoof`` at a tiny size
  against the JAX tools with the same arguments, both at f32
  (COMPUTE_DTYPE): the same detected counts and pair counts; the scale,
  thresholds, rates and medians within 1e-4 (f32 forwards of one embedder
  differ by ~1e-5 between the packages); eval_spoof's rounded metrics
  within 2e-4 (a last rounded digit).
- A calibration written by either package's tool is taken by the other
  package's engine, and refused by both once its fingerprint is off.
- ``migrate_retinaface_npz`` gives the JAX tool's npz and exit codes.
- ``demo_server`` serves on the CPU and ``mock_camera_worker`` pushes to it.
- The new tools import no JAX.
"""

import json
import os
import queue
import runpy
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from frp_tpu.config import load_config as j_load_config
from frp_tpu.engine.pipeline import RecognitionEngine as JEngine

from frp_tpu_torch.config import load_config
from frp_tpu_torch.engine.pipeline import RecognitionEngine
from frp_tpu_torch.models import nn as tnn
from frp_tpu_torch.models.iresnet import init_iresnet
from frp_tpu_torch.models.params import load_params
from frp_tpu_torch.testing import onnx_export as ox
from frp_tpu_torch.tools import (
    calibrate_embedder,
    eval_spoof,
    import_real_weights,
    migrate_retinaface_npz,
    tiered_eval,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
TINY = ["--identities", "2", "--variants", "2"]
SPOOF_TINY = ["--identities", "2", "--per-identity", "2", "--e2e-scenes", "8"]


@pytest.fixture(autouse=True)
def _two_threads_and_port_padding():
    """Two intra-op threads a test (the suite runs files in parallel worker
    processes), and the port's padding mode restored afterwards."""
    n, mode = torch.get_num_threads(), tnn._PADDING_MODE
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    tnn._PADDING_MODE = mode


def _jax_tool(name: str, argv: list) -> None:
    """Run tools/<name>.py as a script, in this process."""
    old = sys.argv
    sys.argv = [f"tools/{name}.py"] + argv
    try:
        runpy.run_path(os.path.join(REPO, "tools", f"{name}.py"), run_name="__main__")
    finally:
        sys.argv = old


def _close(a, b, path=""):
    """Two JSON trees: equal strings, ints and keys; floats within TOL."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= TOL, (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setenv("COMPUTE_DTYPE", "float32")
    monkeypatch.delenv("WEIGHTS_DIR", raising=False)
    monkeypatch.delenv("CONV_PADDING", raising=False)


def _real_export(tmp_path) -> str:
    """A genuine torch.onnx export of an iresnet18 mirror (BN not folded)."""
    from tests.test_onnx_torch_export import _export, _IResNet, _realistic_stats

    net = _IResNet().eval()
    _realistic_stats(net, np.random.default_rng(7))
    path = str(tmp_path / "w600k_r18.onnx")
    _export(net, path, fold=False)
    return path


# --- import_real_weights ------------------------------------------------------------

def test_dry_run_validates_a_real_export(tmp_path, capsys):
    path = _real_export(tmp_path)
    import_real_weights.main(["--embedder", path, "--arch", "iresnet18", "--dry-run",
                              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "embedder: imported w600k_r18.onnx" in out and "forward OK on cpu" in out
    assert "dry run: validation passed" in out
    _jax_tool("import_real_weights", ["--embedder", path, "--arch", "iresnet18", "--dry-run"])
    assert "embedder: imported w600k_r18.onnx" in capsys.readouterr().out


@pytest.mark.parametrize("case", ["wrong_arch", "garbage", "embedder_512d"])
def test_import_tool_fails_loudly(tmp_path, monkeypatch, capsys, case):
    """An iresnet export declared as mobilefacenet, a file that is no ONNX,
    and a 512-d embedder (validated at 128-d, as the reference does) exit
    non-zero in both tools, and install nothing. Both run with --dry-run
    (validation comes first either way) and the port's tool against a
    temporary root, so that a refusal that failed could not touch the real
    weights/."""
    if case == "wrong_arch":
        argv = ["--embedder", _real_export(tmp_path), "--arch", "mobilefacenet"]
    elif case == "garbage":
        bad = tmp_path / "bad.onnx"
        bad.write_bytes(b"not an onnx file")
        argv = ["--detector", str(bad)]
    else:
        path = tmp_path / "r18_512.onnx"
        path.write_bytes(ox.iresnet_graph(init_iresnet(0, variant="iresnet18", embed_dim=512)))
        argv = ["--embedder", str(path), "--arch", "iresnet18"]
    argv += ["--dry-run"]
    monkeypatch.setattr(import_real_weights, "REPO", str(tmp_path))
    before = sorted(os.listdir(os.path.join(REPO, "weights")))
    with pytest.raises(SystemExit) as port:
        import_real_weights.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as jax_:
        _jax_tool("import_real_weights", argv)
    assert port.value.code not in (0, None) and jax_.value.code not in (0, None)
    if case == "embedder_512d":
        assert "shape mismatch" in str(port.value.code) and "shape mismatch" in str(jax_.value.code)
    assert sorted(os.listdir(os.path.join(REPO, "weights"))) == before


def test_install_and_remeasure_in_a_temporary_root(tmp_path, monkeypatch, capsys, f32):
    """Install into <root>/weights of a temporary root; the re-measure runs
    are the port's tools with the same --device, run in that root. The
    first (calibrate_embedder) is run here at a tiny size: it measures the
    installed export (the shipped iresnet18, written as a w600k-style graph)
    beside the shipped detector."""
    root = tmp_path / "root"
    (root / "weights").mkdir(parents=True)
    emb = str(tmp_path / "r18.onnx")
    with open(emb, "wb") as f:
        f.write(ox.iresnet_graph(load_params(os.path.join(REPO, "weights", "iresnet18.npz"))))
    spoof = tmp_path / "m3.onnx"
    spoof.write_bytes(ox.mobilenetv3_graph(load_params(os.path.join(REPO, "weights", "spoof.npz"))))
    before = sorted(os.listdir(os.path.join(REPO, "weights")))
    calls = []

    def run(cmd, cwd, env, check):
        calls.append((cmd, cwd))
        assert check and env["PYTHONPATH"].split(os.pathsep)[0] == REPO

    monkeypatch.setattr(import_real_weights, "REPO", str(root))
    monkeypatch.setattr(import_real_weights.subprocess, "run", run)
    import_real_weights.main(["--embedder", emb, "--spoof", str(spoof), "--arch", "iresnet18",
                              "--device", "cpu"])
    assert sorted(os.listdir(root / "weights")) == ["embedder.onnx", "spoof.onnx"]
    assert (root / "weights" / "embedder.onnx").read_bytes() == open(emb, "rb").read()
    tools = [c[0][2] for c in calls]
    assert tools == ["frp_tpu_torch.tools.calibrate_embedder", "frp_tpu_torch.tools.tiered_eval",
                     "frp_tpu_torch.tools.eval_spoof"]
    for cmd, cwd in calls:
        assert cmd[0] == sys.executable and cmd[-2:] == ["--device", "cpu"] and cwd == str(root)
    assert calls[0][0][3:5] == ["--arch", "iresnet18"]

    monkeypatch.chdir(root)
    cal = calibrate_embedder.main(calls[0][0][3:] + TINY)
    assert cal["weights_file"] == "embedder.onnx" and cal["backend"] == "cpu"
    assert os.path.exists(root / "weights" / "calibration_iresnet18.json")
    assert sorted(os.listdir(os.path.join(REPO, "weights"))) == before


# --- the measuring tools against the JAX tools -------------------------------------

@pytest.fixture
def calibrations(tmp_path, f32):
    """calibration.json written by each package's tool, same arguments."""
    out = {}
    for name, run in (("port", lambda a: calibrate_embedder.main(a + ["--device", "cpu"])),
                      ("jax", lambda a: _jax_tool("calibrate_embedder", a))):
        path = tmp_path / name / "calibration.json"
        run(TINY + ["--out", str(path)])
        out[name] = path
    return out


def test_calibrate_embedder_matches_jax(calibrations):
    got, want = (json.loads(calibrations[k].read_text()) for k in ("port", "jax"))
    assert got["backend"] == want["backend"] == "cpu"
    assert got["detected_scenes"] == want["detected_scenes"]
    assert abs(got["distance_scale"] / want["distance_scale"] - 1) <= TOL
    _close(got, want)

    # a calibration written by either package is taken by the other's engine
    wd = calibrations["port"].parent.parent / "weights"
    wd.mkdir()
    for name in ("retinaface_synthetic.npz", "mobilefacenet.npz", "spoof.npz"):
        shutil.copy(os.path.join(REPO, "weights", name), wd / name)
    kw = dict(det_size=128, max_faces_per_frame=2, weights_dir=str(wd))
    engines = {"port": lambda: RecognitionEngine(load_config(**kw), device="cpu"),
               "jax": lambda: JEngine(j_load_config(**kw))}
    for writer, reader in (("port", "jax"), ("jax", "port")):
        cal = json.loads(calibrations[writer].read_text())
        (wd / "calibration.json").write_text(json.dumps(cal))
        assert engines[reader]().distance_scale == pytest.approx(cal["distance_scale"], abs=0)
        cal["weights_sha256"] = "0" * 64
        (wd / "calibration.json").write_text(json.dumps(cal))
        with pytest.raises(RuntimeError, match="calibrated for"):
            engines[reader]()


def test_tiered_eval_matches_jax(tmp_path, f32):
    tiered_eval.main(TINY + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    _jax_tool("tiered_eval", TINY + ["--out", str(tmp_path / "jax.json")])
    got, want = (json.loads((tmp_path / f"{k}.json").read_text()) for k in ("port", "jax"))
    for tier in want["tiers"]:
        assert got["tiers"][tier]["detected"] == want["tiers"][tier]["detected"] > 0
    _close(got, want)


def test_eval_spoof_matches_jax(tmp_path, f32):
    eval_spoof.main(SPOOF_TINY + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    _jax_tool("eval_spoof", SPOOF_TINY + ["--out", str(tmp_path / "jax.json")])
    got, want = (json.loads((tmp_path / f"{k}.json").read_text()) for k in ("port", "jax"))
    for leg in ("crop_matched", "crop_attenuated_50pct", "e2e_frames"):
        assert (got[leg]["n_real"], got[leg]["n_fake"]) == (want[leg]["n_real"], want[leg]["n_fake"])
        for k, v in want[leg].items():
            assert abs(got[leg][k] - v) <= 2e-4, (leg, k, got[leg][k], v)
    assert {k: v for k, v in got.items() if not isinstance(v, dict)} == \
        {k: v for k, v in want.items() if not isinstance(v, dict)}


# --- migrate_retinaface_npz ---------------------------------------------------------

def _old_checkpoint(path):
    """The shipped detector in the round-2 layout: fpn_td/0 <-> fpn_merge/1."""
    with np.load(os.path.join(REPO, "weights", "retinaface_synthetic.npz")) as d:
        flat = {k: d[k] for k in d.files}
    old = {}
    for k, v in flat.items():
        if k.startswith("fpn_td/"):
            i = int(k.split("/")[1])
            k = f"fpn_merge/{1 - i}/" + k.split("/", 2)[2]
        old[k] = v
    np.savez(path, **old)


@pytest.mark.parametrize("case", ["old", "migrated", "not_retinaface"])
def test_migrate_retinaface_npz_equals_jax(tmp_path, case):
    from tools.migrate_retinaface_npz import migrate as j_migrate

    for name in ("port", "jax"):
        path = tmp_path / f"{name}.npz"
        if case == "old":
            _old_checkpoint(path)
        elif case == "migrated":
            shutil.copy(os.path.join(REPO, "weights", "retinaface_synthetic.npz"), path)
        else:
            np.savez(path, **{"stem/w": np.zeros(3, np.float32)})
    rc = migrate_retinaface_npz.main([str(tmp_path / "port.npz")])
    assert rc == j_migrate(str(tmp_path / "jax.npz")) == (1 if case == "not_retinaface" else 0)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    if case == "old":  # the migrated file is the shipped one again
        with np.load(tmp_path / "port.npz") as a, \
                np.load(os.path.join(REPO, "weights", "retinaface_synthetic.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])


# --- the serving tools, and no JAX ---------------------------------------------------

def test_demo_server_and_mock_camera_worker_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    server = subprocess.Popen(
        [sys.executable, "-m", "frp_tpu_torch.tools.demo_server", "--device", "cpu",
         "--port", "0", "--no-scan"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in server.stdout], daemon=True).start()
    try:
        line = ""
        while "serving on" not in line:
            line = lines.get(timeout=240)  # the warmup scans 5 cameras at det 640
        url = line.split("serving on ")[1].strip()
        res = subprocess.run(
            [sys.executable, "-m", "frp_tpu_torch.tools.mock_camera_worker", "--url", url,
             "--camera-id", "9", "--interval", "0", "--count", "2"],
            cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
        assert res.stdout.splitlines() == ["pushed frame 0 -> 200", "pushed frame 1 -> 200"], \
            res.stdout + res.stderr
    finally:
        server.terminate()
        server.wait(timeout=60)


def test_new_tools_import_no_jax():
    code = (
        "import importlib, sys\n"
        "for n in ('import_real_weights', 'calibrate_embedder', 'tiered_eval', 'eval_spoof',\n"
        "          'migrate_retinaface_npz', 'demo_server', 'mock_camera_worker'):\n"
        "    importlib.import_module('frp_tpu_torch.tools.' + n)\n"
        "import frp_tpu_torch.testing.onnx_export\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'frp_tpu', 'tools')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    res = subprocess.run([sys.executable, "-m", "frp_tpu_torch.tools.migrate_retinaface_npz"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 2 and "Usage" in res.stdout
