"""PyTorch port, the bench (``frp_tpu_torch/bench.py``) against the
reference bench's scene, producer and engine on the CPU: the cameras,
sprites and motion bit for bit against ``bench.py:140-200``'s loop (carried
here, since it is inline in the reference's ``main()``), the stacked I420
batches and delta payloads against the JAX package's ``LetterboxCache`` and
``DeltaEncoder``, the stacked-ticks contract with a motion whose band moves
(where the reference's hints of the last tick alone leave stale blocks), the
CPU self-test, the device policy, the import rule, and bench frames through
the port's and the JAX engine."""

import ast
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from frp_tpu.config import load_config as j_load_config
from frp_tpu.engine.batching import DeltaEncoder as JDeltaEncoder
from frp_tpu.engine.batching import LetterboxCache as JLetterboxCache
from frp_tpu.engine.batching import active_rows_for as j_active_rows_for
from frp_tpu.engine.pipeline import RecognitionEngine as JEngine
from frp_tpu.train.synthetic import render_face as j_render_face

from frp_tpu_torch import bench
from frp_tpu_torch.config import load_config
from frp_tpu_torch.engine.batching import DeltaEncoder, LetterboxCache
from frp_tpu_torch.engine.pipeline import RecognitionEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET, BLOCK, TICKS_OF_MOTION = 640, 128, 16


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs its files in parallel worker processes: two intra-op
    threads a test keep those from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --- the reference's scene and producer, as bench.py writes them inline ----

def ref_scene():
    """bench.py:140-175: the gallery draws, then 8 cameras rendered on the
    whole frame with the JAX package's render_face."""
    rng = np.random.default_rng(0)
    gallery = [rng.normal(size=128) for _ in range(100)]
    cams, sprites = [], []
    for c in range(8):
        rgb = rng.integers(20, 110, size=(1080, 1920, 3), dtype=np.uint8)
        for gy in range(3):
            for gx in range(4):
                if gy == 1 and gx == 1:
                    continue
                size = float(rng.uniform(150, 240))
                cx = gx * 480 + 240 + float(rng.uniform(-60, 60))
                cy = gy * 360 + 180 + float(rng.uniform(-40, 40))
                j_render_face(rgb, cx, cy, size, rng)
        bgr = np.ascontiguousarray(rgb[..., ::-1])
        y0, x0, sp = 540 - 140, 720 - 140, 280
        base = bgr.copy()
        sprite_rgb = np.ascontiguousarray(base[y0 : y0 + sp, x0 : x0 + sp][..., ::-1]).copy()
        j_render_face(sprite_rgb, sp // 2, sp // 2, 200.0, rng)
        sprites.append((base, np.ascontiguousarray(sprite_rgb[..., ::-1]), y0, x0))
        cams.append(bgr)
    return gallery, cams, sprites


def ref_advance(cams, sprites, t):
    """bench.py:184-198, advance_motion at tick t."""
    bands = []
    for cam, (base, sprite, y0, x0) in zip(cams, sprites):
        sp = sprite.shape[0]
        dx = (t % 8) * 24
        if t > 0:
            prev_dx = ((t - 1) % 8) * 24
            cam[y0 : y0 + sp, x0 + prev_dx : x0 + prev_dx + sp] = base[
                y0 : y0 + sp, x0 + prev_dx : x0 + prev_dx + sp]
        cam[y0 : y0 + sp, x0 + dx : x0 + dx + sp] = sprite
        bands.append([(y0, y0 + sp)])
    return bands


def ref_producer(cams, sprites, ticks):
    """bench.py:200-254 with the JAX package's LetterboxCache: (the first
    batch, next_ticks), next_ticks hinting each slot with its camera's last
    tick alone."""
    rows = j_active_rows_for([f.shape[:2] for f in cams], DET) or DET
    cur = np.empty((8, rows * 3 // 2, DET), np.uint8)
    caches = [JLetterboxCache(DET, rows, buf=cur[i]) for i in range(8)]
    tick = [0]

    def host_prep(dirty=None):
        for i, frame in enumerate(cams):
            caches[i].update(frame, None if dirty is None else dirty[i])
        return cur, "yuv420"

    batch, _ = host_prep()
    big = None
    if ticks > 1:
        big = np.empty((8 * ticks,) + batch.shape[1:], np.uint8)
        for t in range(ticks):
            big[t * 8 : (t + 1) * 8] = batch
        batch = big

    def next_ticks():
        hints = []
        b = None
        for t in range(ticks):
            bands = ref_advance(cams, sprites, tick[0])
            tick[0] += 1
            b, _ = host_prep(bands)
            if ticks > 1:
                big[t * 8 : (t + 1) * 8] = b
            hints.extend(c.dirty_blocks(BLOCK) for c in caches)
        return (big if ticks > 1 else b), hints

    return batch, next_ticks


@pytest.fixture(scope="module")
def scenes():
    """(the reference's gallery, cameras and sprites; the port's gallery and
    Scene), all at tick 0. Tests take deep copies."""
    gallery, cams, sprites = ref_scene()
    rng = np.random.default_rng(0)
    port_gallery = bench.gallery_entries(rng, 128)
    return gallery, cams, sprites, port_gallery, bench.Scene(rng)


# --- (a) the scene and its motion ------------------------------------------

def test_scene_and_motion_equal_the_reference_loop(scenes):
    gallery, cams, sprites, port_gallery, scene = copy.deepcopy(scenes)
    assert [n for n, _ in port_gallery] == [f"person_{i}" for i in range(100)]
    for (_, got), want in zip(port_gallery, gallery):
        np.testing.assert_array_equal(got, want)
    assert len(scene.cams) == len(cams) == 8
    for got, want in zip(scene.sprites, sprites):
        np.testing.assert_array_equal(got[0], want[0])  # the pristine base
        np.testing.assert_array_equal(got[1], want[1])  # the sprite
        assert got[2:] == want[2:]
    for got, want in zip(scene.cams, cams):
        np.testing.assert_array_equal(got, want)
    for t in range(TICKS_OF_MOTION):
        assert scene.advance() == ref_advance(cams, sprites, t)
        for i, (got, want) in enumerate(zip(scene.cams, cams)):
            np.testing.assert_array_equal(got, want, err_msg=f"tick {t}, camera {i}")


# --- (b) the producer's batches and payloads -------------------------------

@pytest.mark.parametrize("ticks", [1, 2])
def test_producer_batches_and_payloads_equal_the_reference(scenes, ticks):
    _, cams, sprites, _, scene = copy.deepcopy(scenes)
    prod = bench.Producer(scene, DET, ticks, BLOCK)
    got, fmt = prod.first()
    want, ref_next = ref_producer(cams, sprites, ticks)
    assert fmt == "yuv420" and got.shape == (8 * ticks, 368 * 3 // 2, DET)
    np.testing.assert_array_equal(got, want)
    enc, ref_enc = DeltaEncoder(block_bytes=BLOCK), JDeltaEncoder(block_bytes=BLOCK)
    kinds, last = [], None
    for sub in range(TICKS_OF_MOTION // ticks):
        b, f, hints = prod.next_ticks()
        rb, ref_hints = ref_next()
        np.testing.assert_array_equal(b, rb, err_msg=f"submission {sub}")
        assert prod.last is b and len(hints) == 8 * ticks
        p, rp = enc.encode(b, hints=hints), ref_enc.encode(rb, hints=ref_hints)
        kinds.append(p[0])
        assert p[0] == rp[0], sub
        for x, y in zip(p[1:], rp[1:]):
            np.testing.assert_array_equal(x, y, err_msg=f"submission {sub}")
        if p[0] == "delta":
            # fresh arrays at every encode: the transfer thread may still
            # hold the last payload when the producer makes the next
            assert not np.shares_memory(p[1], b) and not np.shares_memory(p[2], b)
            if last is not None and last[0] == "delta":
                assert not np.shares_memory(p[1], last[1])
                assert not np.shares_memory(p[2], last[2])
        last = p
    assert kinds == ["raw"] + ["delta"] * (TICKS_OF_MOTION // ticks - 1)


# --- (c) stacked ticks: the twins of tests/test_bench_ticks.py, and a band
# that moves --------------------------------------------------------------

SIZE, ROWS = 640, 368
NCAM, TICKS = 2, 2
Y0, Y1 = 300, 428  # the walking subject's fixed source row band


def _reconstruct(prev, payload):
    if payload[0] == "raw":
        return np.array(payload[1], copy=True).reshape(prev.shape)
    return DeltaEncoder.apply_host(prev, payload[1], payload[2])


def test_stacked_two_tick_delta_bit_exact():
    """Twin of test_bench_ticks.py's first case on the port's classes: the
    subject walks inside a fixed band, wrapping (old and new positions
    disjoint), and each slot is hinted with its camera's last update."""
    rng = np.random.default_rng(7)
    cams = [np.ascontiguousarray(rng.integers(0, 255, (720, 1280, 3), dtype=np.uint8))
            for _ in range(NCAM)]
    assert ROWS * SIZE * 3 // 2 % BLOCK == 0
    cur = np.empty((NCAM, ROWS * 3 // 2, SIZE), np.uint8)
    caches = [LetterboxCache(SIZE, ROWS, buf=cur[i]) for i in range(NCAM)]
    for i, f in enumerate(cams):
        caches[i].update(f)
    big = np.empty((NCAM * TICKS, ROWS * 3 // 2, SIZE), np.uint8)
    enc = DeltaEncoder(block_bytes=BLOCK)
    prev, step = None, 0
    deltas = shipped = raw_bytes = 0
    for sub in range(12):
        hints = []
        for t in range(TICKS):
            for i, f in enumerate(cams):
                x = (step % 9) * 130
                f[Y0:Y1, x : x + 90] = rng.integers(0, 255, (Y1 - Y0, 90, 3), dtype=np.uint8)
                caches[i].update(f, dirty=[(Y0, Y1)])
                big[t * NCAM + i] = cur[i]
                hints.append(caches[i].dirty_blocks(BLOCK))
            step += 1
        payload = enc.encode(big, hints=hints)
        flat = big.reshape(NCAM * TICKS, -1)
        if payload[0] == "delta":
            deltas += 1
            shipped += payload[1].nbytes + payload[2].nbytes
            raw_bytes += flat.nbytes
        got = _reconstruct(np.zeros_like(flat) if prev is None else prev, payload)
        np.testing.assert_array_equal(got, flat, err_msg=f"submission {sub}")
        prev = got
    assert deltas >= 10
    assert shipped < raw_bytes / 2


def test_stacked_hints_cover_multi_step_diff():
    """Twin of test_bench_ticks.py's second case: with a fixed band, the
    last update's hint covers every block that two steps changed."""
    rng = np.random.default_rng(11)
    f = np.ascontiguousarray(rng.integers(0, 255, (720, 1280, 3), np.uint8))
    cache = LetterboxCache(SIZE, ROWS)
    before = cache.update(f).copy().reshape(-1)
    for x in (0, 1040):
        f[Y0:Y1, x : x + 90] = rng.integers(0, 255, (Y1 - Y0, 90, 3), np.uint8)
        after = cache.update(f, dirty=[(Y0, Y1)]).copy().reshape(-1)
    hint = cache.dirty_blocks(BLOCK)
    covered = np.zeros(before.size // BLOCK, bool)
    for b0, b1 in hint:
        covered[b0:b1] = True
    differing = (before != after).reshape(-1, BLOCK).any(axis=1)
    assert np.flatnonzero(differing & ~covered).size == 0


class _BandScene:
    """Two 720p cameras whose changed 64-row band moves down a step a tick
    (a subject walking toward the camera), with the decoder's hint of each
    tick's band."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.cams = [np.ascontiguousarray(self.rng.integers(0, 255, (720, 1280, 3), np.uint8))
                     for _ in range(NCAM)]
        self.tick = 0

    def advance(self):
        y0 = 40 + (self.tick % 9) * 72
        self.tick += 1
        for f in self.cams:
            f[y0 : y0 + 64] = self.rng.integers(0, 255, (64, 1280, 3), np.uint8)
        return [[(y0, y0 + 64)] for _ in self.cams]


def _full_letterbox(cams) -> np.ndarray:
    """Each camera letterboxed whole into I420 (the reference of a cache)."""
    return np.stack([LetterboxCache(SIZE, ROWS).update(f).copy() for f in cams])


@pytest.mark.parametrize("ticks", [2, 3])
def test_stacked_union_hints_follow_a_moving_band(ticks):
    """Slot t*N+i's previous content is camera i `ticks` ticks back, so its
    hint must cover every band since: the producer's union does, and the
    stacked stream rebuilds a full letterbox of every tick bit for bit. The
    reference's hint of tick t alone misses the earlier bands and leaves
    stale blocks (pinned beside it)."""
    scene, ref = _BandScene(3), _BandScene(3)
    prod = bench.Producer(scene, SIZE, ticks, BLOCK)
    assert prod.rows == ROWS
    ref_cur = np.empty((NCAM, ROWS * 3 // 2, SIZE), np.uint8)
    ref_caches = [LetterboxCache(SIZE, ROWS, buf=ref_cur[i]) for i in range(NCAM)]
    ref_big = np.empty((NCAM * ticks, ROWS * 3 // 2, SIZE), np.uint8)
    b, _ = prod.first()
    for i, f in enumerate(ref.cams):
        ref_caches[i].update(f)
    ref_big[:] = np.concatenate([ref_cur] * ticks)
    enc, ref_enc = DeltaEncoder(block_bytes=BLOCK), DeltaEncoder(block_bytes=BLOCK)
    prev = ref_prev = None
    stale = 0
    for sub in range(8):
        want = []
        b, _, hints = prod.next_ticks()
        ref_hints = []
        for t in range(ticks):
            bands = ref.advance()
            for i, f in enumerate(ref.cams):
                ref_caches[i].update(f, bands[i])
                ref_hints.append(ref_caches[i].dirty_blocks(BLOCK))
            ref_big[t * NCAM : (t + 1) * NCAM] = ref_cur
            want.append(_full_letterbox(ref.cams))
        want = np.concatenate(want).reshape(NCAM * ticks, -1)
        flat = b.reshape(NCAM * ticks, -1)
        np.testing.assert_array_equal(flat, want, err_msg=f"cache, submission {sub}")
        if sub > 0:
            assert all(h is not None for h in hints)
        p = enc.encode(b, hints=hints)
        prev = _reconstruct(np.zeros_like(flat) if prev is None else prev, p)
        np.testing.assert_array_equal(prev, want, err_msg=f"union hints, submission {sub}")
        rp = ref_enc.encode(ref_big, hints=ref_hints)
        ref_prev = _reconstruct(np.zeros_like(flat) if ref_prev is None else ref_prev, rp)
        stale += int((ref_prev != want).reshape(NCAM * ticks, -1, BLOCK).any(axis=2).sum())
    assert stale > 0, "the last tick's hint alone should miss the earlier bands"


# --- (d) the CPU self-test --------------------------------------------------

def _reference_detail_keys() -> set:
    """The keys of bench.py's "detail" dict, read from its source."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "detail" and isinstance(v, ast.Dict):
                    return {kk.value for kk in v.keys}
    raise AssertionError("bench.py has no detail dict")


def test_bench_selftest_runs_main_on_the_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("BENCH_TICKS", None)
    res = subprocess.run([sys.executable, "-m", "frp_tpu_torch.tools.bench_selftest"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, res.stdout
    out = json.loads(lines[0])
    assert {"metric", "value", "unit", "vs_baseline", "detail"} <= set(out)
    detail = out["detail"]
    missing = _reference_detail_keys() - set(detail)
    assert not missing, missing
    assert {"device_busy_ms_per_batch", "embed_stats", "embed_stats_timed",
            "detection_to_alert_ms", "kernel_launches", "resident_check", "device"} <= set(detail)
    assert detail["device"] == "cpu" and "cpu" in out["metric"]
    assert detail["peak_flops_assumed"] == 989e12
    assert detail["windows_completed"] == 2 and detail["delta_transfer"] is True
    assert detail["resident_check"]["windows"] == 2
    assert detail["embed_stats_timed"]["redone"] == 0
    assert len(detail["detection_to_alert_ms"]) == 15
    assert detail["kernel_launches"] == {"detection_head": 0, "warp_crops": 0, "greedy_nms": 0}


# --- (e) the device policy --------------------------------------------------

def test_bench_without_cpu_raises_where_there_is_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m", "frp_tpu_torch.bench", "--once"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert not [ln for ln in res.stdout.splitlines() if ln.startswith("{")]


# --- (f) the import rule ----------------------------------------------------

def test_bench_and_its_selftest_import_no_jax_nor_frp_tpu():
    """The package walk of test_torch_host.py's import test reaches both new
    modules; importing them runs nothing and loads neither JAX nor the JAX
    package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import frp_tpu_torch\n"
        "for m in pkgutil.walk_packages(frp_tpu_torch.__path__, 'frp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'frp_tpu')]\n"
        "assert not bad, bad\n"
        "for n in ('frp_tpu_torch.bench', 'frp_tpu_torch.tools.bench_selftest'):\n"
        "    assert n in sys.modules, n\n"
        "print('walked')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == "walked"


# --- (g) bench frames through both engines ---------------------------------

def test_bench_frames_through_the_port_and_the_jax_engine(scenes):
    """Two frames of the bench's batch with the walking face present, at det
    640 and f32, with the bench's gallery: valid, count and best_idx (where
    valid) bit for bit, 12 faces a frame."""
    _, _, _, gallery, scene = copy.deepcopy(scenes)
    prod = bench.Producer(scene, DET, 1, BLOCK)
    prod.first()
    batch, fmt, _ = prod.next_ticks()
    frames = np.ascontiguousarray(batch[:2])
    kw = dict(det_size=DET, max_faces_per_frame=16, frames_per_batch=2, compute_dtype="float32")
    jeng = JEngine(j_load_config(**kw), seed=0)
    teng = RecognitionEngine(load_config(**kw), device="cpu")
    for eng in (jeng, teng):
        for name, emb in gallery:
            eng.gallery.add(name, emb)
    want = jeng.fetch(jeng.submit(frames, fmt=fmt))
    got = teng.fetch(teng.submit(frames, fmt=fmt))
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["count"], want["count"])
    np.testing.assert_array_equal(want["count"], [12, 12])
    v = want["valid"]
    np.testing.assert_array_equal(got["best_idx"][v], want["best_idx"][v])
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], rtol=0, atol=1e-2)


# --- (h) chip_smoke.py's phase 17 on a canned attempt -----------------------

def test_smoke_phase_holds_the_attempts_line(monkeypatch):
    """Phase 17 parses the child's last JSON line and holds faces, the
    resident check and the launches; a shortfall of faces is held to the
    f32 engine's count."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    detail = {
        "faces_per_batch": 192, "delta_transfer": True, "windows_completed": 1, "batches": 120,
        "resident_check": {"windows": 1, "payloads": [126]}, "device": "NVIDIA H100, 700.00 W",
        "detection_to_alert_ms": [20.0] * 15,
        "kernel_launches": {"detection_head": 195, "warp_crops": 195, "greedy_nms": 0},
    }
    seen = {}

    def fake_run(cmd, **kw):
        seen.update(cmd=cmd, env=kw["env"])
        line = json.dumps({"value": 1.0, "metric": "m", "detail": detail})
        return subprocess.CompletedProcess(cmd, 0, stdout="noise\n" + line + "\n", stderr="")

    monkeypatch.setattr(smoke.subprocess, "run", fake_run)
    got = smoke.run_bench(torch.device("cpu"))
    assert seen["cmd"][1:] == ["-m", "frp_tpu_torch.bench", "--once"]
    assert seen["env"]["BENCH_WINDOWS"] == "1" and seen["env"]["BENCH_TICKS"] == "2"
    assert got["launches"]["detection_head"] == 195 and got["f32_faces"] is None
    monkeypatch.setattr(smoke, "bench_f32_faces", lambda dev: 190)
    for change, ok in (({"faces_per_batch": 190}, True), ({"faces_per_batch": 188}, False),
                       ({"resident_check": None}, False),
                       ({"kernel_launches": {"detection_head": 100, "warp_crops": 100,
                                             "greedy_nms": 0}}, False)):
        detail.update(change)
        if ok:
            assert smoke.run_bench(torch.device("cpu"))["f32_faces"] == 190
        else:
            with pytest.raises(AssertionError):
                smoke.run_bench(torch.device("cpu"))
        detail.update(faces_per_batch=192, resident_check={"windows": 1, "payloads": [126]},
                      kernel_launches={"detection_head": 195, "warp_crops": 195, "greedy_nms": 0})


def test_launch_counts_read_and_clear_the_three_wrappers():
    """``frp_tpu_torch.ops.launches`` (the bench's ``kernel_launches`` and
    chip_smoke.py's counts) reads each kernel wrapper's LAUNCHES under the
    kernel's name, and ``reset_launches`` sets them to 0."""
    from frp_tpu_torch.ops import align_cuda, detection_cuda, launches, nms_cuda, reset_launches

    saved = launches()
    try:
        detection_cuda.LAUNCHES, align_cuda.LAUNCHES, nms_cuda.LAUNCHES = 3, 2, 1
        assert launches() == {"detection_head": 3, "warp_crops": 2, "greedy_nms": 1}
        reset_launches()
        assert launches() == {"detection_head": 0, "warp_crops": 0, "greedy_nms": 0}
    finally:
        detection_cuda.LAUNCHES = saved["detection_head"]
        align_cuda.LAUNCHES = saved["warp_crops"]
        nms_cuda.LAUNCHES = saved["greedy_nms"]
