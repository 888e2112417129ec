"""The harness as a whole on the CPU: a cell, a traffic mix, a metric and
a kernel added as new files are found without an edit; nothing a cell
loads is JAX or the reference package; a sound run comes out correct and
each fault a stream cell can have comes out not correct; the control
fails the cell's limits. The ``cuda`` cases run the same at full size on
the card."""

import ast
import copy
import glob
import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import common

ROOT = common.ROOT
CELLS = [w["name"] for w in common.load_json(os.path.join(ROOT, "BENCHMARK.json"))["workloads"]]


def test_new_files_are_found_without_an_edit(tmp_path):
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: open(p, "rb").read() for p in glob.glob(str(tmp_path / "perfbench/**/*"), recursive=True)
              if os.path.isfile(p)}
    bench = common.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cfg = common.load_json(os.path.join(ROOT, "perfbench/configs/iresnet50-512.json"))
    cfg.update(name="mfn-crowd", embedder_arch="mobilefacenet", embed_dim=128)
    (tmp_path / "perfbench/configs/mfn-crowd.json").write_text(json.dumps(cfg))
    tr = common.load_json(os.path.join(ROOT, "perfbench/traffic/stream.json"))
    tr["scene"]["static_faces"] = 5
    (tmp_path / "perfbench/traffic/crowd.json").write_text(json.dumps(tr))
    (tmp_path / "perfbench/limits/mfn.crowd.json").write_text('{"box_px": 1.0}')
    (tmp_path / "perfbench/metrics/fetch_ms.stream.py").write_text(
        "def read(run):\n    return 42.0\n")
    (tmp_path / "perfbench/kernels/new_kernel.py").write_text(
        "NAME = 'new_kernel'\nPATTERN = r'new_kernel'\n\n\ndef work(shapes):\n    return 1.0, 2.0\n")
    bench["configs"].append({"name": "mfn-crowd", "source": "https://arxiv.org/abs/1804.07573",
                             "file": "perfbench/configs/mfn-crowd.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "mfn.crowd", "config": "mfn-crowd", "traffic": "crowd",
                               "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("mfn.crowd")
    bench["per_layer"].append({"name": "fetch_ms.stream", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "engine calls",
                               "moves": "faces_per_busy_s", "workloads": ["mfn.crowd"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = common.load_cell("mfn.crowd", root=str(tmp_path))
    assert spec["config"]["name"] == "mfn-crowd"
    assert spec["traffic"]["scene"]["static_faces"] == 5
    assert spec["limits"] == {"box_px": 1.0}
    assert "fetch_ms.stream" in [m["name"] for m in spec["per_layer"]]
    assert common.metric_reader("fetch_ms.stream", root=str(tmp_path))({}) == 42.0
    assert "new_kernel" in [k.NAME for k in common.kernel_counts(root=str(tmp_path))]
    after = {p: open(p, "rb").read() for p in before}
    assert after == before


def test_each_cell_reports_what_its_metrics_move():
    for name in CELLS:
        spec = common.load_cell(name)
        e2e = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec["per_layer"]
        assert all(m["moves"] in e2e for m in spec["per_layer"])


def test_nothing_a_cell_loads_is_jax_or_the_reference_package():
    code = (
        "import sys, json\n"
        "from perfbench import common, run, stream, control, flops, check, trace, weights\n"
        "from perfbench.reference import pipeline, nets, precision, embedders\n"
        "import frp_tpu_torch.engine.pipeline, frp_tpu_torch.engine.batching, frp_tpu_torch.ops\n"
        f"for c in {CELLS!r}:\n"
        "    spec = common.load_cell(c)\n"
        "    [common.metric_reader(m['name']) for m in spec['per_layer']]\n"
        "common.kernel_counts()\n"
        "print(json.dumps(common.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "frp_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert common.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "frp_tpu.sub", object())
    assert common.forbidden_modules() == ["frp_tpu"]


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(ROOT, "perfbench/reference/**/*.py"), recursive=True):
        tree = ast.parse(open(path).read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        tops = {n.split(".")[0] for n in names}
        assert not tops & {"frp_tpu_torch", "frp_tpu", "jax", "jaxlib", "flax"}, (path, tops)


def test_run_refuses_a_machine_without_the_cards(monkeypatch, capsys):
    import torch

    from perfbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


# -- a run's comparison on the CPU, with faults planted in the timed path ----

def tiny(cell: str, dtype: str = "float32") -> dict:
    """The cell at one camera, two ticks a batch, a shallow stream and the
    engine at float32 on the CPU, with the cell's own limits."""
    spec = copy.deepcopy(common.load_cell(cell))
    spec["config"]["compute_dtype"] = dtype
    tr = spec["traffic"]
    tr["scene"]["cameras"] = 1
    tr.update(ticks_per_batch=2, depth=2, group=1, warm_batches=2, check_batches=2,
              trace_seconds=0.5)
    return spec


def _stale_state(eng):
    """The delta step returns the resident batch unchanged."""
    st = eng._replicas[0]["stages"]
    st["delta_ingest"] = lambda prev, idx, blocks: (prev, st["ingest"](prev))


def _half_batch(eng):
    """The second half of every batch's frames is left out."""
    st = eng._replicas[0]["stages"]
    detect = st["detect"]

    def half(params, frames, priors):
        out = detect(params, frames, priors)
        b = out["valid"].shape[0]
        out["valid"][b // 2:] = False
        out["count"] = out["valid"].sum(-1, dtype=out["count"].dtype)
        return out

    st["detect"] = half


def _some_distances_off(eng):
    """Every fourth slot's best distance is 0.05 off: a third of the faces,
    which leaves the medians alone."""
    st = eng._replicas[0]["stages"]
    match_pack = st["match_pack"]

    def off(*args):
        out = match_pack(*args)
        out[:, ::4, 17] = out[:, ::4, 17] + 0.05
        return out

    st["match_pack"] = off


def _altered_answer(eng):
    """Frame 0's faces are matched to the next gallery entry."""
    st = eng._replicas[0]["stages"]
    match_pack = st["match_pack"]

    def altered(*args):
        out = match_pack(*args)
        out[0, :, 16] = out[0, :, 16] + 1.0
        return out

    st["match_pack"] = altered


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, _stale_state, _half_batch, _altered_answer,
                                   _some_distances_off],
                         ids=["sound", "state_unchanged", "half_batch", "answer_altered",
                              "some_distances_off"])
def test_a_fault_in_the_timed_path_is_not_correct(cell, fault):
    """Each fault a one-card cell can have (the exchange between cards is
    not one: every cell runs on one card)."""
    from perfbench import run

    result, rows, _ = run.execute(tiny(cell), 2**33 + 17, 2.0, False, device="cpu", fault=fault)
    assert result["correct"] is (fault is None), rows
    assert list(result)[-1] == "checks"


def test_the_untraced_window_sends_its_own_batches():
    """The window opens with nothing in flight and counts every batch it
    sent, fetched after it closed too; on the CPU no card is busy."""
    from perfbench import run

    spec = tiny(CELLS[0])
    result, rows, rec = run.execute(spec, 2**33 + 19, 1.0, False, device="cpu")
    assert result["correct"], rows
    ks = [k for k, _, _ in rec["batches"]]
    assert ks == list(range(ks[0], ks[0] + len(ks)))
    assert ks[0] == spec["traffic"]["warm_batches"] + spec["traffic"]["depth"] + 1
    assert len(ks) >= spec["traffic"]["depth"] + spec["traffic"]["group"]
    assert result["metrics"]["faces_per_busy_s"]["value"] is None


def test_the_control_fails_the_cells_limits():
    from perfbench.check import judge
    from perfbench.control import control_numbers

    for cell in CELLS:
        spec = tiny(cell)
        ok, rows = judge(dict(control_numbers(spec, 2**33 + 5, "cpu"), frame_off=0),
                         spec["limits"])
        assert not ok, rows


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(card, cell):
    from perfbench import run

    result, rows, _ = run.execute(common.load_cell(cell), 2**33 + 29, 3.0, True)
    assert result["correct"], rows
    assert result["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_on_the_card(card, cell):
    from perfbench.check import judge
    from perfbench.control import control_numbers

    spec = common.load_cell(cell)
    ok, rows = judge(dict(control_numbers(spec, 2**33 + 31, "cuda"), frame_off=0),
                     spec["limits"])
    assert not ok, rows
