"""PyTorch port, the accuracy diagnostics on the CPU against the JAX
package's ``tools/`` scripts:

- ``diagnose_e2e_gap`` (paths A, C and B on tier-2 scenes) and
  ``prototype_flip_tta`` (baseline against flip-averaged, tiers 0-3) at
  mobilefacenet, 2 identities x 2 variants, both packages at f32
  (COMPUTE_DTYPE). Bit-equal: scenes, detected (per tier detected_base,
  detected_flipped, common) and every path's and tier's n_same / n_diff.
  Within tolerances: the landmark error (mean, median, p90) within 0.05 px;
  each TPR / FPR exactly equal, with no pair distance within 1e-4 of a
  threshold (asserted: the distances of both packages are captured); AUC,
  EER and medians within 1e-4.
- The port's ``letterbox(..., to_rgb=True)`` on a 1080p BGR scene equals
  the JAX one bit for bit (path C's input), and ``similarity_np`` equals the
  JAX tool's.
- The two modules import no JAX and nothing of ``frp_tpu``; neither default
  ``--out`` lies under ``benchmarks/`` (the reference's records); at the
  default ``--device`` each raises where there is no card.

Each package's run of a tool is a module-scoped fixture, shared by the cases
that read it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from frp_tpu.engine import batching as j_batching
from frp_tpu.train import pairs as j_pairs

from frp_tpu_torch.engine import batching
from frp_tpu_torch.tools import diagnose_e2e_gap, prototype_flip_tta
from frp_tpu_torch.train import pairs
from tests.test_torch_tools import _jax_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--arch", "mobilefacenet", "--identities", "2", "--variants", "2"]
THRESHOLDS = (0.4, 0.6)
LM_TOL = 0.05  # px, det-640
TOL = 1e-4  # AUC, EER, medians; and no distance this close to a threshold
PATHS = ("path_a_engine_e2e", "path_c_gt_landmarks_det640", "path_b_gt_landmarks_native")
TOOLS = {"diagnose_e2e_gap": diagnose_e2e_gap, "prototype_flip_tta": prototype_flip_tta}


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(tmp, module, name: str, package: str, argv: list) -> dict:
    """One package's run of tool ``name`` at f32 on the CPU, two intra-op
    threads; returns its JSON report and the pair distances of each
    ``pair_distances`` call, in call order."""
    dists = []
    pd = module.pair_distances

    def recording(embeddings, labels):
        same, diff = pd(embeddings, labels)
        dists.append((np.asarray(same, np.float64), np.asarray(diff, np.float64)))
        return same, diff

    out = tmp / f"{package}.json"
    n = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("COMPUTE_DTYPE", "float32")
        mp.delenv("WEIGHTS_DIR", raising=False)
        mp.delenv("CONV_PADDING", raising=False)
        mp.delenv("FRP_RESIZE_INTERP", raising=False)
        mp.setattr(module, "pair_distances", recording)
        torch.set_num_threads(2)
        try:
            if package == "port":
                TOOLS[name].main(argv + ["--device", "cpu", "--out", str(out)])
            else:
                _jax_tool(name, argv + ["--out", str(out)])
        finally:
            torch.set_num_threads(n)
    return {"report": json.loads(out.read_text()), "dists": dists}


@pytest.fixture(scope="module")
def diag_port(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("diag"), pairs, "diagnose_e2e_gap", "port", TINY)


@pytest.fixture(scope="module")
def diag_jax(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("diag"), j_pairs, "diagnose_e2e_gap", "jax", TINY)


@pytest.fixture(scope="module")
def flip_port(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("flip"), pairs, "prototype_flip_tta", "port", TINY)


@pytest.fixture(scope="module")
def flip_jax(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("flip"), j_pairs, "prototype_flip_tta", "jax",
                TINY + ["--cpu"])


def _hold_metrics(got: dict, want: dict, where: str) -> None:
    """threshold_metrics of the two packages: pair counts and rates equal,
    the rest within TOL."""
    assert got.keys() == want.keys(), where
    for k, v in want.items():
        if k.startswith(("n_", "tpr@", "fpr@")):
            assert got[k] == v, (where, k, got[k], v)
        else:
            assert abs(got[k] - v) <= TOL, (where, k, got[k], v)


def _hold_distances(got: list, want: list) -> None:
    """The same pairs in both packages, each distance within TOL of the
    other's and none within TOL of a threshold (so each rate is exact)."""
    assert len(got) == len(want)
    for (gs, gd), (ws, wd) in zip(got, want):
        for g, w in ((gs, ws), (gd, wd)):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
            for t in THRESHOLDS:
                both = np.concatenate([g, w])
                assert np.abs(both - t).min() > TOL, (t, both)


# --- diagnose_e2e_gap ---------------------------------------------------------------

def test_diagnose_port_report(diag_port):
    """The port's report on the CPU: the reference's fields in their order,
    faces found, and one pair set for each of paths A, C and B."""
    r = diag_port["report"]
    assert list(r) == ["arch", "tier", "backend", "scenes", "detected",
                       "landmark_err_det640_px", *PATHS]
    assert (r["arch"], r["tier"], r["backend"], r["scenes"]) == ("mobilefacenet", 2, "cpu", 4)
    assert 0 < r["detected"] <= r["scenes"]
    assert len(diag_port["dists"]) == 3
    assert 0 < r["landmark_err_det640_px"]["median"] <= r["landmark_err_det640_px"]["p90"]


def test_diagnose_counts_equal_jax(diag_port, diag_jax):
    got, want = diag_port["report"], diag_jax["report"]
    assert {k: v for k, v in got.items() if not isinstance(v, dict)} == \
        {k: v for k, v in want.items() if not isinstance(v, dict)}
    for path in PATHS:
        assert (got[path]["n_same"], got[path]["n_diff"]) == \
            (want[path]["n_same"], want[path]["n_diff"]), path


def test_diagnose_metrics_match_jax(diag_port, diag_jax):
    got, want = diag_port["report"], diag_jax["report"]
    for k, v in want["landmark_err_det640_px"].items():
        assert abs(got["landmark_err_det640_px"][k] - v) <= LM_TOL, (k, got, want)
    _hold_distances(diag_port["dists"], diag_jax["dists"])
    for path in PATHS:
        _hold_metrics(got[path], want[path], path)


# --- prototype_flip_tta -------------------------------------------------------------

def test_flip_tta_port_report(flip_port):
    """The port's report on the CPU: the reference's fields, four tiers, the
    common scenes no more than either orientation found."""
    r = flip_port["report"]
    assert list(r) == ["arch", "identities", "variants", "seed", "tiers"]
    assert (r["arch"], r["identities"], r["variants"], r["seed"]) == \
        ("mobilefacenet", 2, 2, prototype_flip_tta.SEED)
    assert list(r["tiers"]) == ["0", "1", "2", "3"]
    for row in r["tiers"].values():
        assert list(row) == ["scenes", "detected_base", "detected_flipped", "common",
                             "baseline", "flip_avg"]
        assert 0 < row["common"] <= min(row["detected_base"], row["detected_flipped"])
        assert row["baseline"]["n_same"] == row["flip_avg"]["n_same"]
    assert len(flip_port["dists"]) == 8


def test_flip_tta_counts_equal_jax(flip_port, flip_jax):
    got, want = flip_port["report"], flip_jax["report"]
    assert {k: v for k, v in got.items() if k != "tiers"} == \
        {k: v for k, v in want.items() if k != "tiers"}
    for tier, w in want["tiers"].items():
        g = got["tiers"][tier]
        for k in ("scenes", "detected_base", "detected_flipped", "common"):
            assert g[k] == w[k], (tier, k)
        for leg in ("baseline", "flip_avg"):
            assert (g[leg]["n_same"], g[leg]["n_diff"]) == (w[leg]["n_same"], w[leg]["n_diff"])


def test_flip_tta_metrics_match_jax(flip_port, flip_jax):
    _hold_distances(flip_port["dists"], flip_jax["dists"])
    for tier, w in flip_jax["report"]["tiers"].items():
        for leg in ("baseline", "flip_avg"):
            _hold_metrics(flip_port["report"]["tiers"][tier][leg], w[leg], f"{tier}/{leg}")


# --- path C's host pieces -----------------------------------------------------------

@pytest.mark.parametrize("case", ["linear", "area", "no_cv2"])
def test_letterbox_to_rgb_matches_jax(monkeypatch, case):
    """Path C letterboxes a 1080p BGR scene to det 640 with to_rgb=True:
    the port's bytes, scale and offsets are JAX's, with either decimation
    kernel and with the numpy fallback where cv2 is missing."""
    scenes, _lms, _labels = diagnose_e2e_gap.render_scenes(1, 1, 2)
    if case == "no_cv2":
        monkeypatch.setattr(batching, "cv2", None)
        monkeypatch.setattr(j_batching, "cv2", None)
    else:
        monkeypatch.setenv("FRP_RESIZE_INTERP", case)
    got = batching.letterbox(scenes[0], 640, to_rgb=True)
    want = j_batching.letterbox(scenes[0], 640, to_rgb=True)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].shape == (640, 640, 3) and got[1:] == want[1:]
    # to_rgb swaps the channels of the letterboxed BGR image, nothing else
    bgr = batching.letterbox(scenes[0], 640)[0]
    np.testing.assert_array_equal(got[0], bgr[..., ::-1])


def test_similarity_np_equals_the_reference():
    from tools.diagnose_e2e_gap import similarity_np as j_similarity_np

    from frp_tpu_torch.ops.align import ARCFACE_TEMPLATE_112

    rng = np.random.default_rng(3)
    tmpl = np.asarray(ARCFACE_TEMPLATE_112, np.float32)
    for _ in range(20):
        src = rng.uniform(0, 1920, size=(5, 2)).astype(np.float32)
        np.testing.assert_array_equal(diagnose_e2e_gap.similarity_np(src, tmpl),
                                      j_similarity_np(src, tmpl))


# --- imports, defaults ---------------------------------------------------------------

def test_diagnostics_import_no_jax():
    code = (
        "import sys\n"
        "import frp_tpu_torch.tools.diagnose_e2e_gap, frp_tpu_torch.tools.prototype_flip_tta\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'frp_tpu', 'tools')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_default_out_is_not_under_benchmarks(name):
    """The reference's records (benchmarks/*_profile.json) stay the
    reference's: the port writes under build/frp_tpu_torch/."""
    out = os.path.realpath(TOOLS[name].parse_args([]).out)
    assert os.path.commonpath([out, os.path.realpath(os.path.join(REPO, "benchmarks"))]) != \
        os.path.realpath(os.path.join(REPO, "benchmarks"))
    assert os.path.dirname(out) == os.path.realpath(os.path.join(REPO, "build", "frp_tpu_torch"))


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_default_device_raises_without_a_card(name, tmp_path, monkeypatch):
    """No silent CPU: at the default device, with no card, the tool raises
    before it renders or writes anything."""
    assert TOOLS[name].parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TOOLS[name].main(TINY + ["--out", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()
