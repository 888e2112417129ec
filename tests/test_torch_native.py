"""PyTorch port, the host library and the hintless-camera path, on the CPU
against the JAX package:

- ``frp_tpu_torch/csrc/framepack.cpp`` is ``native/framepack.cpp`` byte for
  byte, built by the port into its own hash-named library; the port's
  ``letterbox_i420_batch``, ``delta_blocks`` (count and fill) and
  ``dirty_bands`` (the bands and the updated previous frame) equal the JAX
  package's bit for bit, and the port's numpy copies;
- with the library missing, every path gives the same bytes through the
  numpy copies and the change detector is off, as in the JAX package;
- over a hintless camera sequence (static, moving, a scene cut, an outage
  and a return with a band that reverts, a camera-set change) the port's
  cached batches, delta hints and payloads equal the JAX package's;
- after any sequence of fresh reads, stale reads and outages the cached
  batch equals a full letterbox of the current frames (a fixed sequence, a
  hypothesis search, the outage repair and the mixed-hints rule; the JAX
  package ghosts on the mixed sequence, its fault, pinned here);
- chip_smoke.py's phase 15 runs on the CPU at small sizes.

The JAX package's library is loaded from a private build of its own source
(``reference_framepack``), never from ``native/libframepack.so``: the JAX
package builds that shared path in place with no lock between processes, and
a test worker that loads it half-written keeps no library for the rest of its
life (its fault, pinned here).
"""

import contextlib
import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import frp_tpu.engine.batching as jbatch
import frp_tpu.utils.native as jnative

import frp_tpu_torch.engine.batching as tbatch
import frp_tpu_torch.utils.native as tnative
from frp_tpu_torch.ops import cuda_build
from frp_tpu_torch.platform.state import SyntheticSource

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [((1080, 1920), 640, 368), ((720, 1280), 640, 368), ((720, 1280), 640, 640),
          ((123, 77), 128, 128), ((97, 401), 128, 64)]


def build_reference_framepack(out_dir):
    """Builds the JAX package's native/framepack.cpp with its own command
    (frp_tpu/utils/native.py::_build) into out_dir, under a temporary name
    renamed into place, so no reader sees a partial file. Returns the path."""
    path = os.path.join(str(out_dir), "libframepack.so")
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", tmp, jnative._SRC_PATH, "-lpthread"],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, path)
    return path


@contextlib.contextmanager
def reference_framepack_loaded(out_dir):
    """The JAX package's loader on a private build in out_dir, loaded afresh;
    its _LIB_PATH, _lib and _tried are put back as they were on exit."""
    path = build_reference_framepack(out_dir)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB_PATH", path)
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_tried", False)
        lib = jnative.get_framepack()
        assert lib is not None and lib.framepack_version() == 4
        yield lib


@pytest.fixture(scope="module")
def reference_framepack(tmp_path_factory):
    """The JAX package's library for a test module that holds the port
    against it (import it there), whatever state this worker's loader is in."""
    with reference_framepack_loaded(tmp_path_factory.mktemp("reference_framepack")) as lib:
        yield lib


@pytest.fixture(scope="module")
def libs(reference_framepack):
    """Both packages' libraries, loaded (this host has g++)."""
    assert tnative.get_framepack() is not None, "the port's library did not build"


def _frames(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*shape, 3), dtype=np.uint8) for _ in range(n)]


def _moved(frame, seed, bands=((10, 30),)):
    """A copy of frame with new content in the given row bands (fractions of
    the height in per cent)."""
    out = frame.copy()
    rng = np.random.default_rng(seed)
    h = frame.shape[0]
    for a, b in bands:
        y0, y1 = h * a // 100, max(h * a // 100 + 1, h * b // 100)
        out[y0:y1] = rng.integers(0, 256, out[y0:y1].shape, dtype=np.uint8)
    return out


# --- the library -----------------------------------------------------------------

def test_framepack_source_is_the_jax_source_byte_for_byte():
    with open(os.path.join(REPO, "native", "framepack.cpp"), "rb") as a, \
            open(os.path.join(REPO, "frp_tpu_torch", "csrc", "framepack.cpp"), "rb") as b:
        assert a.read() == b.read()


def test_the_port_builds_and_loads_its_own_library(libs):
    path = tnative.library_path()
    assert path == cuda_build.host_library_path("framepack") and os.path.exists(path)
    assert os.path.dirname(path) == cuda_build.BUILD_DIR
    assert os.path.basename(path).startswith("libframepack-") and "native" not in path
    assert tnative.get_framepack().framepack_version() == tnative.VERSION == 4
    # a second build finds the library in place and returns the same path
    assert cuda_build.build_host("framepack") == path


def test_processes_building_at_once_share_one_library(tmp_path):
    """Six processes build the library into one empty directory at once (as
    the test workers and a server's threads do): each renames its own
    temporary file into place, all load the same path, none is left
    half-written."""
    code = ("import ctypes, sys; import frp_tpu_torch.ops.cuda_build as cb; "
            "cb.BUILD_DIR = sys.argv[1]; p = cb.build_host('framepack'); "
            "print(p, ctypes.CDLL(p).framepack_version())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    lines = {o.strip() for o, _ in outs}
    assert len(lines) == 1
    path, version = lines.pop().split()
    assert version == "4" and os.listdir(tmp_path) == [os.path.basename(path)]


def test_a_half_written_reference_library_stays_off_and_the_fixture_recovers(tmp_path, monkeypatch):
    """The JAX loader finds native/libframepack.so while another process's
    linker still writes it: a 0-byte file fails to load, and the loader keeps
    no library for the process's life, also once the file is complete (its
    fault, pinned here). From that state the fixture's private build loads
    version 4 of the JAX package's own source, not the port's library, and
    the loader's state is put back on exit."""
    lost = tmp_path / "libframepack.so"
    lost.write_bytes(b"")
    monkeypatch.setattr(jnative, "_LIB_PATH", str(lost))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    assert jnative.get_framepack() is None and jnative._tried
    (tmp_path / "linker").mkdir()
    shutil.copyfile(build_reference_framepack(tmp_path / "linker"), lost)  # the writer finishes
    assert lost.stat().st_size > 0 and jnative.get_framepack() is None
    frames = _frames((97, 401), 2, 1)
    assert jnative.letterbox_i420_batch(frames, 128, rows=64) is None
    lost_state = (jnative._LIB_PATH, jnative._lib, jnative._tried)
    (tmp_path / "private").mkdir()
    with reference_framepack_loaded(tmp_path / "private") as lib:
        assert jnative.get_framepack() is lib and lib.framepack_version() == 4
        assert lib._name == jnative._LIB_PATH == str(tmp_path / "private" / "libframepack.so")
        assert lib._name != tnative.library_path()
        got = jnative.letterbox_i420_batch(frames, 128, rows=64)
        want = tnative.letterbox_i420_batch(frames, 128, rows=64)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert (jnative._LIB_PATH, jnative._lib, jnative._tried) == lost_state
    assert jnative.get_framepack() is None


@pytest.mark.parametrize("shape,size,rows", SHAPES)
def test_letterbox_i420_batch_equals_jax_and_numpy(libs, shape, size, rows):
    frames = _frames(shape, 3, sum(shape))
    got = tnative.letterbox_i420_batch(frames, size, rows=rows)
    want = jnative.letterbox_i420_batch(frames, size, rows=rows)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for k, f in enumerate(frames):
        img, s, off = tbatch.letterbox_i420(f, size, rows)
        assert np.array_equal(got[0][k], img)
        assert got[1][k] == np.float32(s) and tuple(got[2][k]) == tuple(off)


@pytest.mark.parametrize("shape,size,rows", SHAPES)
def test_delta_blocks_count_and_fill_equal_jax_and_numpy(libs, shape, size, rows):
    frames = _frames(shape, 3, 7)
    moved = [_moved(f, k, ((10, 30), (60, 62))) for k, f in enumerate(frames)]
    moved[1] = frames[1]  # one frame unchanged
    prev, cur = (tbatch.build_batch_i420(dict(enumerate(fs)), size, active_rows=rows)[0]
                 .reshape(3, -1) for fs in (frames, moved))
    block = 128
    nblocks = cur.shape[1] // block
    count = tnative.delta_blocks(cur, prev, block, 0)
    assert count == jnative.delta_blocks(cur, prev, block, 0) == tbatch.changed_blocks(cur, prev, block, 0)
    changed = (cur != prev).reshape(3, nblocks, block).any(axis=2)
    assert count == int(changed.sum(axis=1).max()) > 0 and not changed[1].any()
    for cap in (count, max(1, count // 2)):  # every changed block fits; the cap cuts
        out = []
        for pkg in (tnative, jnative):
            idx = np.full((3, cap), -1, np.int32)
            blocks = np.zeros((3, cap, block), np.uint8)
            assert pkg.delta_blocks(cur, prev, block, cap, idx, blocks) == count
            out.append((idx, blocks))
        idx = np.full((3, cap), -1, np.int32)
        blocks = np.zeros((3, cap, block), np.uint8)
        assert tbatch.changed_blocks(cur, prev, block, cap, idx, blocks) == count
        out.append((idx, blocks))
        (ti, tb), (ji, jb), (ni, nb) = out
        assert np.array_equal(ti, ji) and np.array_equal(tb, jb)
        assert np.array_equal(ti, ni) and np.array_equal(tb, nb)
        for i in range(3):
            ci = np.flatnonzero(changed[i])[:cap]
            assert np.array_equal(ti[i, : len(ci)], ci) and (ti[i, len(ci):] == -1).all()
            assert np.array_equal(tb[i, : len(ci)], cur[i].reshape(nblocks, block)[ci])


@pytest.mark.parametrize("shape", [(1080, 1920), (720, 1280), (123, 77), (97, 401)])
@pytest.mark.parametrize("band", [16, 7])
def test_dirty_bands_equal_jax_and_update_prev(libs, shape, band):
    prev = _frames(shape, 1, 3)[0]
    cur = _moved(prev, 4, ((0, 3), (20, 41), (45, 46), (98, 100)))
    tp, jp = prev.copy(), prev.copy()
    got, want = tnative.dirty_bands(cur, tp, band), jnative.dirty_bands(cur, jp, band)
    assert got == want and got
    assert np.array_equal(tp, cur) and np.array_equal(jp, cur)
    rows = (cur != prev).reshape(shape[0], -1).any(axis=1)
    covered = np.zeros(shape[0], bool)
    for y0, y1 in got:
        assert y0 % band == 0 and (y1 % band == 0 or y1 == shape[0])
        covered[y0:y1] = True
    assert covered[rows].all() and tnative.dirty_bands(cur, tp, band) == []


def test_wrong_inputs_raise_before_the_library(libs):
    a = np.zeros((4, 1024), np.uint8)
    with pytest.raises(ValueError):
        tnative.delta_blocks(a, np.zeros((4, 512), np.uint8), 128, 0)
    with pytest.raises(ValueError):
        tnative.delta_blocks(a, a.copy(), 128, 4, np.zeros((4, 4), np.int64), np.zeros((4, 4, 128), np.uint8))
    with pytest.raises(ValueError):
        tnative.dirty_bands(np.zeros((8, 8, 3), np.uint8), np.zeros((8, 8, 3), np.uint8)[:, ::-1])


# --- the library missing ------------------------------------------------------------

def _no_library(monkeypatch):
    for mod in (tnative, jnative):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", True)
    assert tnative.get_framepack() is None and jnative.get_framepack() is None


def test_without_the_library_the_numpy_copies_give_the_same_bytes(libs, monkeypatch):
    src = {c: SyntheticSource(256, 144, seed=c) for c in (0, 1)}
    ticks = [{c: s.read()[1] for c, s in src.items()} for _ in range(4)]
    rows = tbatch.active_rows_for([(144, 256)], 128)

    def run(cv2_off):
        if cv2_off:
            monkeypatch.setattr(tbatch, "cv2", None)
        enc = tbatch.DeltaEncoder(block_bytes=128)
        out = []
        for frames in ticks:
            batch, meta = tbatch.build_batch_i420(frames, 128, active_rows=rows)
            out.append((batch, meta.scales, meta.offsets, enc.encode(batch)))
        monkeypatch.setattr(tbatch, "cv2", jbatch.cv2)
        return out

    with_lib = run(cv2_off=True)  # the native packer and block search
    _no_library(monkeypatch)
    assert tnative.letterbox_i420_batch(list(ticks[0].values()), 128) is None
    assert tnative.dirty_bands(ticks[0][0], ticks[1][0].copy()) is None
    assert tnative.delta_blocks(np.zeros((1, 128), np.uint8), np.zeros((1, 128), np.uint8), 128, 0) is None
    without = run(cv2_off=True)  # letterbox_i420 and the numpy search
    for a, b in zip(with_lib, without):
        for x, y in zip(a[:3], b[:3]):
            assert np.array_equal(x, y)
        assert a[3][0] == b[3][0] and all(np.array_equal(x, y) for x, y in zip(a[3][1:], b[3][1:]))
    kinds = [p[3][0] for p in without]
    assert kinds[0] == "raw" and "delta" in kinds, kinds


def test_without_the_library_the_detector_is_off_as_in_jax(libs, monkeypatch):
    _no_library(monkeypatch)
    frames = [_frames((144, 256), 1, 5)[0]]
    frames.append(_moved(frames[0], 6))
    for mod in (tbatch, jbatch):
        det = mod.SourceChangeDetector()
        assert det.hints(frames[0]) is None  # first sight: a full rebuild either way
        assert det.hints(frames[1]) is None and det._disabled and det._prev is None
        state: dict = {}
        for f in (frames[0], frames[0], frames[1]):
            got, _ = mod.build_batch_i420_cached({0: f}, 128, state, active_rows=80)
            assert np.array_equal(got, mod.build_batch_i420({0: f}, 128, active_rows=80)[0])
        assert mod.delta_hints_for(state, 128) == [None]


# --- hintless cameras ----------------------------------------------------------------

def _hintless_ticks():
    """{camera: frame or None} a tick at 256 x 144 (det 128, k = 2, the banded
    path): camera 0 moves (a synthetic face) and cuts to another scene at
    tick 5; camera 1 is static, drops out at tick 7, returns at tick 8 with a
    band changed, which reverts at tick 9; camera 2 joins at tick 11."""
    moving, cut = SyntheticSource(256, 144, seed=0), SyntheticSource(256, 144, seed=9)
    static = SyntheticSource(256, 144, seed=1).read()[1]
    extra = SyntheticSource(256, 144, seed=2)
    ticks = []
    for t in range(14):
        frames = {0: (cut if t >= 5 else moving).read()[1],
                  1: {7: None, 8: _moved(static, 8, ((40, 60),))}.get(t, static)}
        if t >= 11:
            frames[2] = extra.read()[1]
        ticks.append(frames)
    return ticks


def _hintless_run(mod, ticks):
    state: dict = {}
    enc = mod.DeltaEncoder(block_bytes=128)
    out = []
    for frames in ticks:
        rows = mod.active_rows_for([f.shape[:2] for f in frames.values() if f is not None], 128)
        batch, meta = mod.build_batch_i420_cached(frames, 128, state, active_rows=rows)
        want, _ = mod.build_batch_i420(frames, 128, active_rows=rows)
        assert np.array_equal(batch, want)
        hints = mod.delta_hints_for(state, 128)
        out.append((batch.copy(), meta, hints, enc.encode(batch, hints=hints)))
    return out


def test_hintless_sequence_equals_jax(libs):
    ticks = _hintless_ticks()
    jseq, tseq = _hintless_run(jbatch, ticks), _hintless_run(tbatch, ticks)
    for t, ((jb, jm, jh, jp), (tb, tm, th, tp)) in enumerate(zip(jseq, tseq)):
        assert np.array_equal(jb, tb), t
        assert jm.cam_ids == tm.cam_ids and np.array_equal(jm.scales, tm.scales)
        assert np.array_equal(jm.offsets, tm.offsets) and np.array_equal(jm.frame_ok, tm.frame_ok)
        assert jh == th, t
        assert jp[0] == tp[0] and all(np.array_equal(a, b) for a, b in zip(jp[1:], tp[1:])), t
    hints = [h for _, _, h, _ in tseq]
    assert hints[0] == hints[1] == [None, None]  # the caches' first build, the detectors' first sight
    assert hints[3][1] == [] and hints[3][0]  # static: untouched; moving: block ranges
    assert hints[7][1] is None and hints[8][1] is None  # blanked, then a full rebuild on return
    assert hints[11] == [None] * 3  # a new camera set: a fresh state


def test_outage_drops_the_detector_with_the_cache(libs):
    """The outage repair: the detector's copy goes with the blanked slot, so
    a band that reverts to the pre-outage content after the return is not
    reported clean while the slot still holds the returned frame's pixels."""
    base = _frames((144, 256), 1, 11)[0]
    person = _moved(base, 12, ((30, 50),))
    state: dict = {}
    for k, f in enumerate([base, base, base, None, person, base, base]):
        batch, _ = tbatch.build_batch_i420_cached({0: f}, 128, state, active_rows=80)
        if f is None:
            assert 0 not in state["detectors"], "the detector outlived the outage"
            continue
        assert np.array_equal(batch, tbatch.build_batch_i420({0: f}, 128, active_rows=80)[0]), k


def _mixed(mod):
    """A camera whose hints are None on some scans (a probe read between two
    scans) and its source's own on others: cached batch == full letterbox a
    scan (False where it is not)."""
    src = SyntheticSource(256, 144, seed=3)
    state: dict = {}
    equal = []
    for k in range(10):
        frame = src.read()[1]
        hints = src.read_hints() if 3 <= k <= 6 else None
        batch, _ = mod.build_batch_i420_cached({0: frame}, 128, state, hints={0: hints},
                                               active_rows=80)
        equal.append(np.array_equal(batch, mod.build_batch_i420({0: frame}, 128,
                                                                active_rows=80)[0]))
    return equal


def test_mixed_hints_never_ghost(libs):
    """The mixed-hints rule: a detector is dropped whenever its slot is built
    from anything else (here the source's hints), so its copy never lags the
    slot. The JAX package keeps it, and its scans 7-9 leave the face's old
    pixels in the batch (its fault, pinned here; the JAX package stays as it
    is)."""
    assert all(_mixed(tbatch))
    assert _mixed(jbatch)[:7] == [True] * 7 and not all(_mixed(jbatch)[7:])


def test_fixed_sequence_of_fresh_stale_reads_and_outages(libs):
    steps = [("fresh", 0), ("stale", 1), ("stale", 2), ("fresh", 3), ("fresh", 1),
             ("outage", 0), ("fresh", 2), ("stale", 0), ("stale", 0), ("fresh", 3),
             ("stale", 1), ("outage", 0), ("stale", 3), ("stale", 0), ("fresh", 2)]
    _check_sequence(steps)


_POOL = None


def _pool():
    """Four 128 x 72 frames that differ from a base in overlapping row bands
    (det 64, k = 2, the banded path): switching between them changes bands
    and reverts them."""
    global _POOL
    if _POOL is None:
        base = _frames((72, 128), 1, 20)[0]
        _POOL = [base, _moved(base, 21, ((10, 40),)), _moved(base, 22, ((30, 70),)),
                 _moved(base, 23, ((0, 15), (80, 100)))]
    return _POOL


def _check_sequence(steps):
    """Each step a scan of one camera: "fresh" with the source's exact hints
    (the bands changed since the scan's previous frame), "stale" with None (a
    probe read in between), "outage" no frame. The cached batch must equal a
    full letterbox after every scan."""
    pool = _pool()
    state: dict = {}
    last = None
    for kind, i in steps:
        frame = None if kind == "outage" else pool[i]
        hints = None
        if kind == "fresh" and last is not None:
            rows = (frame != last).reshape(72, -1).any(axis=1)
            hints = [(int(y), int(y) + 1) for y in np.flatnonzero(rows)]
        batch, _ = tbatch.build_batch_i420_cached({0: frame}, 64, state, hints={0: hints},
                                                   active_rows=48)
        want, _ = tbatch.build_batch_i420({0: frame}, 64, active_rows=48)
        assert np.array_equal(batch, want), steps
        if frame is not None:
            last = frame


@settings(max_examples=50, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["fresh", "stale", "outage"]),
                          st.integers(0, 3)), min_size=1, max_size=20))
def test_any_sequence_of_reads_keeps_the_cache_exact(steps):
    assert tnative.get_framepack() is not None
    _check_sequence(steps)


# --- chip_smoke.py phase 15, rehearsed -------------------------------------------------

@pytest.fixture
def smoke():
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite's workers share the host's cores
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    yield mod
    torch.set_num_threads(n)


def test_host_phase_runs_on_the_cpu(smoke, monkeypatch):
    """Phase 15 on the CPU at small sizes: (a) the framepack library against
    its numpy versions; (b) 8 PushSource 384x216 cameras at det 384 (k = 1,
    the banded path), 5 ticks with the cut at tick 3, every batch equal to a
    full letterbox, faces and the enrolled match every scan, the static
    slot's hint [] from tick 1, and the mixed-hints replay; (c) the switches
    on two CPU engines at det 128; (d) the stage FLOPs and MFU (launch
    counts and device numbers need the card)."""
    from frp_tpu_torch.config import load_config
    from frp_tpu_torch.engine.pipeline import RecognitionEngine

    monkeypatch.setattr(smoke, "PLATFORM_SOURCE", (384, 216))
    monkeypatch.setattr(smoke, "CUT_TICK", 3)
    ticks = smoke.render_hintless(5)
    assert all(np.array_equal(t[smoke.STATIC_CAMERA], ticks[0][smoke.STATIC_CAMERA]) for t in ticks)
    fp = smoke.run_framepack(ticks)
    assert fp["path"] == tnative.library_path() and fp["count"] > 0
    assert fp["dirty_rows"][smoke.STATIC_CAMERA] == 0
    assert set(fp["ms"]) == {"letterbox", "delta_blocks", "dirty_bands"}
    kw = dict(det_size=384, max_faces_per_frame=4, pre_nms_topk=64, det_conf_threshold=0.3,
              compute_dtype="float32", min_face_quality=0.0)
    hl = smoke.run_hintless(torch.device("cpu"), ticks, **kw)
    assert hl["scans"] == 5 and hl["faces_per_scan"] > 0 and hl["delta"]["desyncs"] == 0
    assert hl["camera0_distance"][1] <= 0.6 and hl["cut_blocks"] > 0
    assert hl["mixed"]["kinds"][3:7] == ["source"] * 4
    small = dict(det_size=128, max_faces_per_frame=4, pre_nms_topk=64, det_conf_threshold=0.3)
    sw = smoke.run_switches(torch.device("cpu"), smoke.render_scenes(2, 128, 0), **small)
    assert len(sw["held"]) == len(smoke.SWITCHES) + 1
    assert all(h["max_abs_err"]["boxes"] == 0.0 for h in sw["held"].values())
    monkeypatch.setattr(smoke, "FRAMES", 2)
    eng = RecognitionEngine(load_config(**small, compute_dtype="float32"), device="cpu")
    sf = smoke.run_stage_flops({"default": (eng, 3, None, 20.0)})["default"]
    assert sf["mfu_busy"] is None and sf["mfu_wall"] == pytest.approx(
        sf["flops"]["total"] / 0.02 / smoke.PEAK_FLOPS_BF16)
