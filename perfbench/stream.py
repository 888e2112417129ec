"""The ``stream`` loop: the program's pipelined engine fed as fast as it
takes batches, a closed loop at a fixed depth, as the program's own bench
drives it (``frp_tpu_torch/bench.py``'s protocol, with one rate over the
whole window in place of the best of several windows).

Three host threads, each timed by the harness's own spans:

- the producer moves the scene's walkers (not timed) and runs the
  program's host encoder on each tick: ``LetterboxCache.update`` and
  ``dirty_blocks`` into one I420 buffer of the cameras, stacked
  ``ticks_per_batch`` ticks deep, then ``DeltaEncoder.encode`` with the
  union of each slot's dirty blocks as hints (span ``encode``);
- the transfer thread calls ``RecognitionEngine.put_payload`` (``put``);
- the main thread calls ``submit_encoded`` (``submit``) and
  ``fetch_many`` in groups (``fetch``), ``depth`` batches in flight.

The gallery holds ``enrolled`` entries near faces the cameras show, each
at a distance from the plain reference's float32 embedding of that face
spread evenly over ``distances`` (the traffic's ``gallery``), so that
matches and decisions on both sides of the tolerance occur, and random
entries for the rest. The reference makes them in set-up and is freed
before the program is built.

The stream starts with a keyframe and runs ``warm_batches`` before the
window opens; the window closes at the first fetch that ends
``seconds`` after it opened.

- Untraced (``--trace 0``): the window opens with nothing in flight and
  closes when every batch it sent has been fetched, under a profile of
  the device's activity alone (``trace.BusyTrace``).
  ``faces_per_busy_s`` is the faces in the results of every batch the
  window sent over the seconds the card was busy in it: the work of
  those batches and no other.
- Traced (``--trace 1``): the window opens at depth ``depth``, as the
  program's bench runs, and ``faces_per_s`` is the faces of every batch
  fetched in it over its wall-clock length (the per-layer
  ``faces_per_s.wall``); the stream then runs on for ``trace_seconds``
  under ``torch.profiler`` (the traced slice).
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time

import numpy as np

from perfbench import common, scene as scene_mod
from perfbench.trace import BusyTrace, DeviceTrace, Spans


class Producer:
    """The cameras' host side: a keyframe batch, then ``ticks`` ticks a
    batch, each camera's slot hint the union of its dirty blocks over the
    ticks since that slot's previous submission."""

    def __init__(self, scene, det: int, ticks: int, block: int, spans: Spans):
        from frp_tpu_torch.engine.batching import LetterboxCache, active_rows_for

        self.scene, self.ticks, self.block, self.spans = scene, ticks, block, spans
        n = len(scene.cams)
        self.rows = active_rows_for([f.shape[:2] for f in scene.cams], det) or det
        self.cur = np.empty((n, self.rows * 3 // 2, det), np.uint8)
        self.caches = [LetterboxCache(det, self.rows, buf=self.cur[i]) for i in range(n)]
        self.history = [collections.deque(maxlen=ticks) for _ in range(n)]
        self.big = np.empty((n * ticks,) + self.cur.shape[1:], np.uint8)

    def _prep(self, dirty):
        for i, (cache, frame) in enumerate(zip(self.caches, self.scene.cams)):
            cache.update(frame, None if dirty is None else dirty[i])
            self.history[i].append(cache.dirty_blocks(self.block))

    def first(self) -> np.ndarray:
        """Every slot the cameras' frames before the first tick."""
        self._prep(None)
        n = len(self.caches)
        for t in range(self.ticks):
            self.big[t * n:(t + 1) * n] = self.cur
        return self.big

    def next_ticks(self):
        """(the batch of the next ``ticks`` ticks, each slot's hint)."""
        n = len(self.caches)
        hints: list = []
        for t in range(self.ticks):
            bands = self.scene.advance()
            t0 = time.perf_counter()
            self._prep(bands)
            self.big[t * n:(t + 1) * n] = self.cur
            hints.extend(scene_mod.union_ranges(list(h)) if len(h) == self.ticks else None
                         for h in self.history)
            self.spans.add("encode", t0, time.perf_counter())
        return self.big, hints


def batch_ticks(k: int, ticks: int) -> list:
    """The scene ticks of batch ``k`` of the stream (k >= 1)."""
    return [(k - 1) * ticks + t for t in range(ticks)]


def letterboxed(scene, cam: int, tick: int, det: int, rows: int) -> np.ndarray:
    """The reference's letterbox of camera ``cam`` at ``tick``, made once a
    distinct frame."""
    from perfbench.reference.pipeline import letterbox_i420

    key = (cam, scene.phase(tick), det, rows)
    if key not in scene.letterboxed:
        scene.letterboxed[key] = letterbox_i420(scene.frame_at(cam, tick), det, rows)
    return scene.letterboxed[key]


def reference_i420(scene, k: int, ticks: int, det: int, rows: int) -> np.ndarray:
    """The reference's letterbox of batch ``k``'s frames, slot t * n + i
    camera i at the batch's tick t."""
    return np.stack([letterboxed(scene, i, tick, det, rows)
                     for tick in batch_ticks(k, ticks) for i in range(len(scene.cams))])


@contextlib.contextmanager
def float32_matmuls():
    """TF32 off for the reference, and back as it was."""
    import torch

    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def make_gallery(cfg: dict, g: dict, rng, scene, rows: int, wdir: str, dev) -> np.ndarray:
    """The run's gallery [entries, D]: ``enrolled`` faces of the first
    tick's frames, drawn from ``rng``, each with an entry at a distance
    from the reference's embedding of it (``distances`` spread evenly, in
    a drawn order) in a random direction, and random unit entries for the
    rest. (Entries turned from their face away from the others' mean were
    tried: a neighbouring anchor's crop then moved a sound bfloat16 pick
    0.3 beyond the nearest.)"""
    import torch

    from perfbench.reference.pipeline import Reference

    det = cfg["det_size"]
    yuv = np.stack([letterboxed(scene, i, 0, det, rows) for i in range(len(scene.cams))])
    with float32_matmuls():
        ref = Reference(cfg, wdir, dev)
        faces = ref.faces(yuv, np.zeros((1, cfg["embed_dim"]), np.float32))
    del ref
    if dev.type == "cuda":  # the program's peak is its own
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    embs = np.concatenate([f["embeddings"] for f in faces])
    m = min(g["enrolled"], len(embs))
    pick = rng.choice(len(embs), size=m, replace=False)
    dists = rng.permutation(np.linspace(*g["distances"], m))
    return scene_mod.gallery(rng, g["entries"], cfg["embed_dim"], embs[pick],
                             [float(d) for d in dists], cfg["distance_scale"])


def build_engine(cfg: dict, frames: int, weights_dir: str, device):
    from frp_tpu_torch.config import load_config
    from frp_tpu_torch.engine.pipeline import RecognitionEngine

    ecfg = load_config(
        det_size=cfg["det_size"], max_faces_per_frame=cfg["max_faces"],
        pre_nms_topk=cfg["pre_nms_topk"], det_conf_threshold=cfg["conf_thresh"],
        det_nms_threshold=cfg["iou_thresh"], det_nms_iom_threshold=cfg["iom_thresh"],
        compute_dtype=cfg["compute_dtype"], embedder_arch=cfg["embedder_arch"],
        embed_dim=cfg["embed_dim"], embed_flip_tta=False, weights_dir=weights_dir,
        frames_per_batch=frames, face_tolerance=cfg["tolerance"])
    eng = RecognitionEngine(ecfg, device=device)
    want = {m: f"{weights_dir}/{f}" for m, f in cfg["weights"].items()}
    if eng.weights_loaded != want:
        raise SystemExit(f"the engine loaded {eng.weights_loaded}, the configuration "
                         f"names {want}")
    if abs(eng.distance_scale - cfg["distance_scale"]) > 1e-6:
        raise SystemExit(f"the engine's distance scale {eng.distance_scale} is not the "
                         f"configuration's {cfg['distance_scale']}")
    return eng


def run(spec: dict, seed: int, seconds: float, trace: bool, device="cuda",
        fault=None) -> dict:
    """One run of a stream cell. ``fault`` (tests only) plants a fault in
    the engine after set-up. Returns the run's record (``run.py``)."""
    import torch

    cfg, tr = spec["config"], spec["traffic"]
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    ticks, block = tr["ticks_per_batch"], tr["block_bytes"]
    frames = tr["scene"]["cameras"] * ticks
    common.log(f"weights for {cfg['name']}, seed {seed}")
    wdir = common.prepare_weights(cfg, seed, dev)
    common.log("scene")
    spans = Spans()
    scene = scene_mod.Scene(rng, tr["scene"])
    prod = Producer(scene, cfg["det_size"], ticks, block, spans)
    common.log("gallery")
    gal = make_gallery(cfg, tr["gallery"], rng, scene, prod.rows, wdir, dev)
    eng = build_engine(cfg, frames, wdir, dev)
    for i, g in enumerate(gal):
        eng.gallery.add(f"entry_{i}", g)
    first = prod.first()
    common.log("warm-up: keyframe and the delta rungs")
    eng.fetch(eng.submit_encoded(("raw", first.copy())))
    eng.precompile_delta_rungs(block=block)
    if fault is not None:
        fault(eng)

    from frp_tpu_torch.engine.batching import DeltaEncoder, DeltaPayload

    enc = DeltaEncoder(block_bytes=block)
    q_enc: queue.Queue = queue.Queue(maxsize=2)
    q_dev: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()
    errors: list = []

    def put_until_stopped(q, item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def producer():
        k = 0
        try:
            while not stop.is_set():
                k += 1
                batch, hints = prod.next_ticks()
                t0 = time.perf_counter()
                e = enc.encode(batch, hints=hints)
                if e[0] == "raw":  # the buffer is rewritten while it waits
                    e = DeltaPayload(("raw", e[1].copy()), e.enc_id, e.seq)
                spans.add("encode", t0, time.perf_counter())
                put_until_stopped(q_enc, (k, e))
        except Exception as ex:  # the main thread re-raises it
            errors.append(ex)
            stop.set()

    def transfer():
        try:
            while not stop.is_set():
                try:
                    k, e = q_enc.get(timeout=0.2)
                except queue.Empty:
                    continue
                t0 = time.perf_counter()
                p = eng.put_payload(e)
                spans.add("put", t0, time.perf_counter())
                put_until_stopped(q_dev, (k, p))
        except Exception as ex:
            errors.append(ex)
            stop.set()

    def next_item():
        while True:
            if errors:
                raise errors[0]
            try:
                return q_dev.get(timeout=0.5)
            except queue.Empty:
                continue

    threads = [threading.Thread(target=producer, daemon=True),
               threading.Thread(target=transfer, daemon=True)]
    for t in threads:
        t.start()

    inflight: collections.deque = collections.deque()
    results: dict = {}
    window = []  # (k, fetch end, faces) of the batches fetched in the window
    last_submitted = 0

    def submit():
        nonlocal last_submitted
        k, p = next_item()
        t0 = time.perf_counter()
        h = eng.submit_encoded(p)
        spans.add("submit", t0, time.perf_counter())
        inflight.append((k, h))
        last_submitted = k

    def fetch(n: int) -> float:
        items = [inflight.popleft() for _ in range(n)]
        t0 = time.perf_counter()
        outs = eng.fetch_many([h for _, h in items])
        t1 = time.perf_counter()
        spans.add("fetch", t0, t1)
        for (k, _), out in zip(items, outs):
            results[k] = out
        return t1

    group, depth = tr["group"], tr["depth"]
    dt = busy = None
    # the profiler's first start loads CUPTI: in set-up, not in the window
    if trace:
        warm = DeviceTrace()
        warm.start()
        warm.stop()
        dt = DeviceTrace()
    elif dev.type == "cuda":
        warm = BusyTrace()
        warm.start()
        warm.stop()
        busy = BusyTrace()
    t_open = t_close = None
    stats0 = None
    fetched = 0
    warm_ends: list = []
    common.log("stream")
    try:
        for _ in range(depth):
            submit()
        while True:
            for _ in range(group):
                submit()
            ks = [k for k, _ in list(inflight)[:group]]
            t_end = fetch(group)
            fetched += group
            if t_open is None:
                warm_ends.append(t_end)
                if fetched >= tr["warm_batches"]:
                    common.log("warm-up batches a second by group: " + ", ".join(
                        f"{group / (b - a):.1f}" for a, b in zip(warm_ends, warm_ends[1:])))
                    if not trace:  # the untraced window sends its own batches only
                        fetch(len(inflight))
                        if busy is not None:
                            busy.start()
                        t_end = time.perf_counter()
                    t_open = t_end
                    setup_s = common.process_age_s()
                    stats0 = dict(eng.embed_stats)
                    if not trace:
                        for _ in range(depth):
                            submit()
                continue
            if t_close is None:
                window.extend((k, t_end, int(results[k]["count"].sum())) for k in ks)
                if t_end - t_open >= seconds:
                    t_close = t_end
                    if not trace:  # send nothing more; every batch sent is the window's
                        ks = [k for k, _ in inflight]
                        t_end = fetch(len(inflight))
                        window.extend((k, t_end, int(results[k]["count"].sum())) for k in ks)
                        t_close = t_end
                        if busy is not None:
                            busy.stop()
                    stats1 = dict(eng.embed_stats)
                    if dt is None:
                        break
                    # the traced slice follows the window on the same stream,
                    # so the profiler's cost stays out of the window
                    dt.start()
            elif t_end - dt.lo >= tr["trace_seconds"]:
                dt.stop()
                break
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a producer or transfer thread outlived the window")
    if errors:
        raise errors[0]
    if dt is not None:
        dt.collect()
    while inflight:  # due answers: fetched, not counted
        fetch(len(inflight))
    peak = common.device_info(1)["memory_peak_bytes"] if dev.type == "cuda" else 0
    resident = eng._delta_prev.cpu().numpy()
    del eng
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    faces = sum(w[2] for w in window)
    busy_s = busy.busy_s() if busy is not None else None
    rec = {
        "e2e": {"faces_per_busy_s": faces / busy_s if busy_s else None, "setup_s": setup_s},
        "faces_per_s": faces / (t_close - t_open),
        "attempted": len(window), "failed": 0,
        "window": (t_open, t_close), "spans": spans, "trace": dt,
        "embed_stats": {k: stats1[k] - stats0[k] for k in stats1},
        "memory_peak_bytes": peak,
        "batches": window, "frames_per_batch": frames,
        "shapes": {"B": frames, "K": cfg["pre_nms_topk"], "M": cfg["max_faces"],
                   "S": cfg["det_size"], "C": cfg["crop_size"]},
        "weights_dir": wdir, "gallery_size": len(gal),
    }
    common.log(f"window {t_close - t_open:.2f} s, {len(window)} batches, {faces} faces"
               + (f", card busy {busy_s:.3f} s" if busy_s else ""))
    span = (t_close - t_open) / 4
    common.log("batches a second by quarter of the window: " + ", ".join(
        f"{sum(1 for w in window if t_open + i * span < w[1] <= t_open + (i + 1) * span) / span:.1f}"
        for i in range(4)))
    rec["numbers"] = check_stream(spec, seed, scene, prod.rows, results, window, resident,
                                  last_submitted, gal, wdir, dev)
    return rec


def sample(window: list, ticks: int, period: int, n: int, seed: int) -> list:
    """``n`` batches of the window, drawn from ``seed``: one of each input
    the scene repeats (where in its period the batch starts), in a drawn
    order."""
    by_phase: dict = {}
    for k, _, _ in window:
        by_phase.setdefault(((k - 1) * ticks) % period, []).append(k)
    rng = np.random.default_rng([seed, 1])
    phases = sorted(by_phase)
    rng.shuffle(phases)
    return [int(rng.choice(by_phase[p])) for p in phases[:n]]


def check_stream(spec, seed, scene, rows, results, window, resident, last_k, gal, wdir,
                 dev) -> dict:
    """The numbers of ``perfbench/check.py`` for a stream run."""
    from perfbench import check
    from perfbench.reference.pipeline import Reference

    cfg, tr = spec["config"], spec["traffic"]
    ticks = tr["ticks_per_batch"]
    ks = sample(window, ticks, scene.period, tr["check_batches"], seed)
    with float32_matmuls():
        ref = Reference(cfg, wdir, dev)
        refs = [ref.faces(reference_i420(scene, k, ticks, cfg["det_size"], rows), gal,
                          check.landmarks(results[k]))
                for k in ks]
    numbers = check.compare([results[k] for k in ks], refs, cfg)
    want = reference_i420(scene, last_k, ticks, cfg["det_size"], rows)
    numbers["frame_off"] = check.frame_off(resident.reshape(want.shape), want)
    numbers["batches"] = ks
    return numbers
