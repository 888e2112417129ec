"""PyTorch port, the embed stage's rung pick on the CPU: the engine picks its
compaction rung from the valid counts of earlier batches that have reached
the host, never waiting for the device, and its fetch redoes a batch whose
count passed the speculated rung. The JAX package picks the rung on the
device (``lax.switch``); both must equal the uncompacted stage.

At det 128 with 16 frames of 4 slots (64 slots: rungs 8, 32, 52), batches of
few faces and of many, in an order that makes the count pass the speculated
rung, fall, and pass it again. Tolerances as
``tests/test_torch_accuracy.py::test_engine_compaction_equals_uncompacted``:
valid, count, best_idx and is_match bit for bit, embeddings and fake_prob
within 1e-5 on valid slots, zeros on the others."""

import numpy as np
import pytest
import torch

from frp_tpu_torch.config import load_config
from frp_tpu_torch.engine.pipeline import SPECULATION_WINDOW, RecognitionEngine
from frp_tpu_torch.testing.synthetic import make_scene

DET = 128
KW = dict(det_size=DET, max_faces_per_frame=4, pre_nms_topk=64,
          det_conf_threshold=0.3, compute_dtype="float32")
RUNGS = [8, 32, 52]


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs its files in parallel worker processes: two intra-op
    threads a test keep those from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(faces_frames: int) -> np.ndarray:
    """16 frames: the first ``faces_frames`` rendered scenes (one or two
    faces each), the rest black."""
    frames = np.zeros((16, DET, DET, 3), np.uint8)
    for i in range(faces_frames):
        frames[i] = make_scene(DET, np.random.default_rng(60 + i), max_faces=2,
                               portrait=i % 3 == 0)[0]
    return frames


@pytest.fixture(scope="module")
def batches():
    return {"low": _batch(3), "high": _batch(16)}


def _engine(monkeypatch, compact=True):
    if not compact:
        monkeypatch.setenv("FRP_EMBED_COMPACT", "0")
    eng = RecognitionEngine(load_config(**KW), device="cpu")
    monkeypatch.delenv("FRP_EMBED_COMPACT", raising=False)
    return eng


def _enrol(engines, frames):
    """The faces of frames, each at its own norm, in every engine's
    gallery."""
    ref = engines[-1].process_frames(frames)
    embs = ref["embeddings"][ref["valid"]]
    embs = embs * np.linspace(0.95, 0.8, len(embs), dtype=np.float32)[:, None]
    for eng in engines:
        for i, e in enumerate(embs):
            eng.gallery.add(f"id{i}", e)


def _hold(got: dict, want: dict) -> None:
    for key in ("valid", "count", "best_idx", "is_match"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    v = want["valid"]
    for key in ("embeddings", "fake_prob"):
        if key in want:
            np.testing.assert_allclose(got[key][v], want[key][v], rtol=0, atol=1e-5, err_msg=key)
            assert not got[key][~v].any(), key


def _expected_stats(counts: list) -> dict:
    """The rung rule over a sequence of valid counts: the smallest rung
    holding the largest of the last SPECULATION_WINDOW counts before a
    batch; the whole batch with none. The slots embedded: the rung, or all
    64 slots of a whole batch, and a redo's rung on top."""
    stats = {"speculated": 0, "redone": 0, "whole": 0, "slots": 0}
    for t, nv in enumerate(counts):
        seen = counts[max(0, t - SPECULATION_WINDOW):t]
        rung = next((r for r in RUNGS if seen and max(seen) <= r), None)
        stats["whole" if rung is None else "speculated"] += 1
        stats["slots"] += 64 if rung is None else rung
        if rung is not None and nv > rung:
            stats["redone"] += 1
            stats["slots"] += next(r for r in RUNGS + [64] if nv <= r)
    return stats


def test_rung_pick_redoes_an_overflow_and_equals_the_uncompacted_engine(batches, monkeypatch):
    """low, high (over the rung of low: redone), four lows (the rung of
    high), high again (the window forgot it: redone), through submit and
    fetch, packed and not."""
    on, off = _engine(monkeypatch), _engine(monkeypatch, compact=False)
    assert on._stages["rungs"](64) == RUNGS and off._stages["rungs"](64) == []
    _enrol([on, off], batches["high"])
    plan = ["low", "high", "low", "low", "low", "low", "high"]
    counts = []
    for t, name in enumerate(plan):
        packed = t % 2 == 0
        got = on.fetch(on.submit(batches[name], packed=packed))
        want = off.fetch(off.submit(batches[name], packed=packed))
        _hold(got, want)
        counts.append(int(want["count"].sum()))
    low, high = counts[0], counts[1]
    assert 0 < low <= RUNGS[0] < high <= RUNGS[-1], counts
    assert on.embed_stats == _expected_stats(counts)
    assert on.embed_stats["redone"] == 2 and on.embed_stats["whole"] == 1
    assert off.embed_stats == {"speculated": 0, "redone": 0, "whole": 0, "slots": 0}


def test_pipelined_submits_redo_in_fetch_many(batches, monkeypatch):
    """Three submits, then one fetch_many: the second batch passes the rung
    of the first and is redone there; equal to submit-then-fetch on another
    engine and to the uncompacted engine."""
    piped, serial, off = _engine(monkeypatch), _engine(monkeypatch), _engine(monkeypatch, False)
    _enrol([piped, serial, off], batches["high"])
    order = [batches["low"], batches["high"], batches["high"]]
    handles = [piped.submit(x) for x in order]
    assert [c is not None for c in handles[1].checks] == [True]
    got = piped.fetch_many(handles)
    want = [serial.fetch(serial.submit(x)) for x in order]
    for g, w, x in zip(got, want, order):
        for key in w:
            if key != "gallery_names":
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        _hold(g, off.fetch(off.submit(x)))
    stats = _expected_stats([int(w["count"].sum()) for w in want])
    assert piped.embed_stats == serial.embed_stats == stats
    assert (stats["speculated"], stats["redone"], stats["whole"]) == (2, 1, 1)
    # a full-tree fetch of a redone batch keeps every output
    again = _engine(monkeypatch)
    for name, emb in zip(*serial.gallery.host_arrays()[::-1]):
        again.gallery.add(name, emb)
    again.fetch(again.submit(batches["low"]))
    full = again.fetch(again.submit(batches["high"], packed=False))
    assert again.embed_stats["redone"] == 1
    _hold(full, off.fetch(off.submit(batches["high"], packed=False)))
    assert full["topk_idx"].shape == (16, 4, 5)
