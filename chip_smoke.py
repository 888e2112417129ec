"""Smoke run of the PyTorch port (``frp_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on its own lines, in order:

1. device   the card's name, and its name and power limit from nvidia-smi.
2. build    nvcc builds the three kernels of ``frp_tpu_torch/csrc`` for
            sm_90a, all at once.
3. kernels  each kernel against its plain PyTorch version on the card at the
            main path's shapes: masks, valid flags and counts bit for bit,
            floats within 1e-3. Each gets its median time over 50 launches
            (CUDA events), its bound, the plain version's time and, for the
            warp, the time of F.grid_sample (a yardstick the port never calls).
4. engine   the port's RecognitionEngine on cuda in the default profile (det
            640, 16 slots, top-256, bf16, spoof and quality on, MobileFaceNet,
            the shipped weights) over a DeltaEncoder stream of 8 rendered 640
            scenes: one keyframe and 20 delta ticks that move a patch in each
            frame, then an enrolment with encode_image and one more scan.
            Checks the launch counts, the resident batch against
            DeltaEncoder.apply_host, the detections and the enrolled match;
            prints frames/s, faces/s and per-stage ms.
5. nms      an engine with pre_nms_topk=512, whose detect stage goes through
            decode + nms_padded_batched and so launches the greedy kernel.
6. parity   the engine at f32 (TF32 off) on cuda and on the CPU over 2
            frames: valid, count and best_idx bit for bit, boxes within
            1e-2 px. With the CPU tests against the JAX package, this chains
            the card's results back to the reference.

Every count of kernel launches is set to 0 just before phases 4 and 5 and
read just after. Any failed check raises, so the run exits non-zero. The
line before the last is one JSON object with every kernel's numbers; the last
line is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
Where torch.cuda.is_available() is false it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from frp_tpu_torch.config import load_config
from frp_tpu_torch.engine.batching import DeltaEncoder
from frp_tpu_torch.engine.pipeline import RecognitionEngine
from frp_tpu_torch.ops import align_cuda, cuda_build, detection_cuda, nms_cuda
from frp_tpu_torch.ops.align import invert_similarity
from frp_tpu_torch.ops.anchors import generate_anchors
from frp_tpu_torch.ops.nms import overlap_matrix
from frp_tpu_torch.testing.synthetic import make_scene

# H100 SXM published peaks (NVIDIA's data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores

PROFILE = dict(det_size=640, max_faces_per_frame=16, pre_nms_topk=256,
               compute_dtype="bfloat16", embedder_arch="mobilefacenet",
               embed_flip_tta=False)
FRAMES = 8
TICKS = 20  # delta ticks after the keyframe
WARM = 3  # ticks left out of the steady-state window
SEED = 0
ATOL = 1e-3

KERNELS = {
    "detection_head": (detection_cuda, "frp_tpu_torch/csrc/detection_head.cu",
                       "frp_tpu/ops/detection_pallas.py:41"),
    "warp_crops": (align_cuda, "frp_tpu_torch/csrc/warp_crops.cu",
                   "frp_tpu/ops/align_pallas.py:58"),
    "greedy_nms": (nms_cuda, "frp_tpu_torch/csrc/greedy_nms.cu",
                   "frp_tpu/ops/nms_pallas.py:26"),
}


def say(phase: str, text: str) -> None:
    print(f"[{phase}] {text}", flush=True)


# --- inputs ------------------------------------------------------------------

def rgb_to_i420(rgb: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 RGB -> [H*3//2, W] uint8 I420: BT.601 studio swing and
    the plane layout of cv2's COLOR_BGR2YUV_I420, chroma as the 2x2 mean
    (the card machine has no cv2)."""
    f = rgb.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 16.0 + 0.257 * r + 0.504 * g + 0.098 * b
    u = 128.0 - 0.148 * r - 0.291 * g + 0.439 * b
    v = 128.0 + 0.439 * r - 0.368 * g - 0.071 * b
    h, w = y.shape

    def q(c):
        return np.clip(np.rint(c), 0, 255).astype(np.uint8)

    def chroma(c):
        return q(c.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))).reshape(h // 4, w)

    return np.concatenate([q(y), chroma(u), chroma(v)], axis=0)


def render_scenes(n: int, size: int, seed: int) -> np.ndarray:
    """n rendered RGB scenes [n, size, size, 3]; every fourth one is a
    single-face portrait (the enrolment shape)."""
    return np.stack([
        make_scene(size, np.random.default_rng(seed + i), max_faces=3, portrait=i % 4 == 0)[0]
        for i in range(n)
    ])


def tick_batch(scenes: np.ndarray, t: int) -> np.ndarray:
    """The I420 batch of tick t: each frame's scene with a 40 px patch that
    moves 24 px a tick along its bottom band."""
    out = []
    for i, img in enumerate(scenes):
        img = img.copy()
        size = img.shape[0]
        x0 = (24 * t + 80 * i) % (size - 40)
        img[size - 48 : size - 8, x0 : x0 + 40] = (30 + 20 * i, 200, 255 - 25 * i)
        out.append(rgb_to_i420(img))
    return np.stack(out)


# --- measurement -------------------------------------------------------------

def device_ms(fn, reps: int = 50, host_bound: bool = False) -> float:
    """Median device time of one call of fn, in ms, from CUDA events around
    each of `reps` calls. A sleep kernel first holds the stream for tens of
    ms, long enough for the host to queue every call of a kernel, so the
    calls run back to back and each time is the device's, not the host's
    launch overhead; if the device drained the queue anyway, this raises.
    The plain versions issue hundreds of small ops a call and keep the
    device waiting on the host whatever the hold: `host_bound=True` takes
    their time as it comes."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(100_000_000)
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    if not host_bound and ev[reps].query():
        raise AssertionError("the device drained the queue before the host filled it: "
                             "the times would be the host's")
    torch.cuda.synchronize()
    return float(np.median([ev[i].elapsed_time(ev[i + 1]) for i in range(reps)]))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations"): the larger of the bytes
    over the memory rate and the operations over the f32 rate."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0


def reset_launches() -> None:
    for mod, _, _ in KERNELS.values():
        mod.LAUNCHES = 0


def launches() -> dict[str, int]:
    return {name: mod.LAUNCHES for name, (mod, _, _) in KERNELS.items()}


# --- phase 3: each kernel against its plain version --------------------------

def check_detection_head(dev, b=FRAMES, det=640, k=256, m=16) -> dict:
    """Kernel 1 at B=8, K=256, M=16 on the 16800 anchors of det 640: random
    head outputs with 64 confident anchors a frame."""
    rng = np.random.default_rng(SEED)
    priors = torch.from_numpy(generate_anchors(det).copy()).to(dev)
    a = priors.shape[0]
    loc = rng.normal(0, 0.4, (b, a, 4)).astype(np.float32)
    ldm = rng.normal(0, 0.4, (b, a, 10)).astype(np.float32)
    scores = rng.uniform(0, 0.25, (b, a)).astype(np.float32)
    for i in range(b):
        scores[i, rng.choice(a, 64, replace=False)] = rng.uniform(0.5, 1.0, 64)
    loc, ldm, scores = (torch.from_numpy(x).to(dev) for x in (loc, ldm, scores))
    payload = detection_cuda.build_payload(loc, ldm, scores, priors, k)
    args = (m, 0.5, 0.4, 0.5, float(det))
    got = detection_cuda.fused_head_kernel(payload, *args)
    want = detection_cuda.fused_head_plain(payload, *args)
    torch.cuda.synchronize()
    if not torch.equal(got[..., 15], want[..., 15]):
        raise AssertionError("detection_head: valid slots differ from the plain version")
    err = max_err(got, want)
    if not err <= ATOL:
        raise AssertionError(f"detection_head: max abs err {err} > {ATOL}")
    # per candidate pair j > i: 19 operations of the effective overlap and one
    # compare; per candidate about 70 of box and landmark decode
    ops = b * k * (k - 1) / 2 * 20 + b * k * 70
    bms, by = bound(payload.numel() * 4 + got.numel() * 4, ops)
    return dict(
        shape=f"B={b} K={k} M={m} A={a}", max_abs_err=err,
        ms=device_ms(lambda: detection_cuda.fused_head_kernel(payload, *args)),
        plain_ms=device_ms(lambda: detection_cuda.fused_head_plain(payload, *args), 10, True),
        bound_ms=bms, bound_by=by, library_ms=None,
    )


def check_warp_crops(dev, frames: torch.Tensor, m=16, s=112) -> dict:
    """Kernel 2 on the rendered uint8 frames [8, 640, 640, 3] with 16 faces a
    frame of mixed size (45 to 560 px) and rotation (up to 40 degrees), four
    of them centred on the border."""
    b, h, w, _ = frames.shape
    rng = np.random.default_rng(SEED + 1)
    th = rng.uniform(-0.7, 0.7, (b, m))
    sc = rng.uniform(0.2, 2.5, (b, m))
    c = rng.uniform(0, [w, h], (b, m, 2))
    c[:, 0, 0], c[:, 1, 0], c[:, 2, 1], c[:, 3, 1] = 0, w - 1, 0, h - 1
    ca, sa = sc * np.cos(th), sc * np.sin(th)
    half = s / 2
    mats = np.stack([
        np.stack([ca, -sa, half - (ca * c[..., 0] - sa * c[..., 1])], -1),
        np.stack([sa, ca, half - (sa * c[..., 0] + ca * c[..., 1])], -1),
    ], -2).astype(np.float32)
    inv = invert_similarity(torch.from_numpy(mats).to(dev))
    got = align_cuda.warp_crops_kernel(frames, inv, s)
    want = align_cuda.warp_crops_plain(frames, inv, s)
    torch.cuda.synchronize()
    err = max_err(got, want)
    if not err <= ATOL:
        raise AssertionError(f"warp_crops: max abs err {err} > {ATOL}")

    # the yardstick: one grid_sample over the f32 NCHW frames, every face's
    # 112 x 112 sample grid stacked along the output height
    src = frames.permute(0, 3, 1, 2).float().contiguous()
    g = torch.arange(s, dtype=torch.float32, device=dev) + 0.5
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    mi = inv[..., None, None]
    sx = mi[:, :, 0, 0] * gx + mi[:, :, 0, 1] * gy + mi[:, :, 0, 2]
    sy = mi[:, :, 1, 0] * gx + mi[:, :, 1, 1] * gy + mi[:, :, 1, 2]
    grid = torch.stack([sx * (2.0 / w) - 1.0, sy * (2.0 / h) - 1.0], -1).reshape(b, m * s, s, 2)

    def library():
        return F.grid_sample(src, grid, mode="bilinear", padding_mode="border",
                             align_corners=False)

    lib = library().reshape(b, 3, m, s, s).permute(0, 2, 3, 4, 1)
    # per output pixel: 8 for its sample coordinate, 4 for clamp and floor,
    # 2 for the weights, 6 a channel for the bilinear blend
    ops = b * m * s * s * (14 + 3 * 6)
    bms, by = bound(frames.numel() + inv.numel() * 4 + got.numel() * 4, ops)
    return dict(
        shape=f"B={b} {h}x{w} M={m} S={s}", max_abs_err=err,
        library_max_abs_err=max_err(lib, want),
        ms=device_ms(lambda: align_cuda.warp_crops_kernel(frames, inv, s)),
        plain_ms=device_ms(lambda: align_cuda.warp_crops_plain(frames, inv, s), 20, True),
        bound_ms=bms, bound_by=by, library_ms=device_ms(library),
    )


def check_greedy_nms(dev, k: int, b=FRAMES) -> dict:
    """Kernel 3 at B=8 on the effective overlap of K boxes 16 to 160 px wide
    spread over a 640 frame, 60 % of them above the score threshold."""
    rng = np.random.default_rng(SEED + k)
    ctr = rng.uniform(0, 640, (b, k, 2))
    wh = rng.uniform(16, 160, (b, k, 2))
    boxes = torch.from_numpy(np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32))
    eff = overlap_matrix(boxes.to(dev), 0.4, 0.5)
    above = torch.from_numpy(rng.random((b, k)) < 0.6).to(dev)
    got = nms_cuda.greedy_suppress_kernel(eff, above, 1.0)
    want = nms_cuda.greedy_suppress_plain(eff, above, 1.0)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"greedy_nms K={k}: keep mask differs from the plain version")
    # the keep mask depends only on the overlaps of the pairs j > i: those
    # f32 values, the above flags and the keep flags, one compare a pair
    pairs = b * k * (k - 1) / 2
    bms, by = bound(pairs * 4 + above.numel() + got.numel(), pairs)
    return dict(
        shape=f"B={b} K={k}", max_abs_err=max_err(got, want),
        ms=device_ms(lambda: nms_cuda.greedy_suppress_kernel(eff, above, 1.0)),
        plain_ms=device_ms(lambda: nms_cuda.greedy_suppress_plain(eff, above, 1.0), 5, True),
        bound_ms=bms, bound_by=by, library_ms=None,
    )


# --- phases 4 to 6: the engine -----------------------------------------------

def stage_ms(events: list) -> dict[str, float]:
    """Median device ms of each stage over the ticks of a stage-event list
    ((name, event) pairs, each tick opening with "start")."""
    per: dict[str, list[float]] = {}
    prev = None
    for name, ev in events:
        if name != "start" and prev is not None:
            per.setdefault(name, []).append(prev.elapsed_time(ev))
        prev = ev
    return {k: float(np.median(v)) for k, v in per.items()}


def run_scan(dev, scenes: np.ndarray, profile: dict, ticks: int, warm: int) -> dict:
    """Phase 4: the delta scan, the resident-batch check and the enrolment."""
    eng = RecognitionEngine(load_config(**profile), device=dev)
    enc = DeltaEncoder(block_bytes=128)
    batches = [tick_batch(scenes, t) for t in range(ticks + 2)]
    payloads = [enc.encode(x) for x in batches]
    kinds = [p[0] for p in payloads]
    if kinds != ["raw"] + ["delta"] * (ticks + 1):
        raise AssertionError(f"payload kinds {kinds}")
    timed = dev.type == "cuda"
    reset_launches()
    n_batches, faces, t0 = 0, 0, None
    host = None
    for t in range(ticks + 1):
        if t == warm:
            if timed:
                torch.cuda.synchronize()
                eng.stage_events = []
            t0, faces = time.perf_counter(), 0
        out = eng.fetch(eng.submit_encoded(payloads[t]))
        n_batches += 1
        faces += int(out["count"].sum())
        flat = batches[t].reshape(len(scenes), -1)
        host = flat.copy() if t == 0 else DeltaEncoder.apply_host(host, payloads[t][1], payloads[t][2])
    elapsed = time.perf_counter() - t0
    steady = ticks + 1 - warm
    stages = stage_ms(eng.stage_events) if timed else {}
    eng.stage_events = None
    if not np.array_equal(host, batches[ticks].reshape(len(scenes), -1)):
        raise AssertionError("apply_host did not rebuild the last batch")
    resident = eng._delta_prev.cpu().numpy().reshape(host.shape)
    if not np.array_equal(resident, host):
        raise AssertionError("the resident batch differs from DeltaEncoder.apply_host")
    if not out["valid"].any():
        raise AssertionError("the scan found no face")

    # enrol one face of a frame that has one, then scan once more
    j = int(np.flatnonzero(out["valid"].any(axis=1))[0])
    enrolled = eng.encode_image(scenes[j])
    if not enrolled:
        raise AssertionError(f"encode_image found no face in scene {j}")
    eng.gallery.add("enrolled", enrolled[0]["embedding"])
    after = eng.fetch(eng.submit_encoded(payloads[ticks + 1]))
    n_batches += 2
    slot = after["gallery_names"].index("enrolled")
    hit = after["valid"][j] & after["is_match"][j] & (after["best_idx"][j] == slot)
    if not hit.any():
        raise AssertionError(f"the enrolled face did not match in frame {j}: "
                             f"distances {after['best_distance'][j][after['valid'][j]]}")
    got = launches()
    want = {"detection_head": n_batches, "warp_crops": n_batches, "greedy_nms": 0}
    if timed and got != want:
        raise AssertionError(f"launches {got}, expected {want}")
    return dict(
        engine=eng, out=out, launches=got, batches=n_batches,
        frames_per_s=steady * len(scenes) / elapsed, faces_per_s=faces / elapsed,
        faces_per_batch=faces / steady, ms_per_batch=elapsed * 1e3 / steady,
        stage_ms=stages, enrolled_frame=j,
        enrolled_distance=float(after["best_distance"][j][hit].min()),
    )


def run_nms_engine(dev, scenes: np.ndarray, profile: dict) -> dict:
    """Phase 5: pre_nms_topk=512 routes detect through the greedy kernel."""
    eng = RecognitionEngine(load_config(**{**profile, "pre_nms_topk": 512}), device=dev)
    payload = DeltaEncoder(block_bytes=128).encode(tick_batch(scenes, 0))
    reset_launches()
    out = eng.fetch(eng.submit_encoded(payload))
    got = launches()
    if dev.type == "cuda" and got != {"detection_head": 0, "warp_crops": 1, "greedy_nms": 1}:
        raise AssertionError(f"pre_nms_topk=512 launches {got}")
    if not out["valid"].any():
        raise AssertionError("the pre_nms_topk=512 engine found no face")
    return dict(launches=got, faces=int(out["count"].sum()))


def run_parity(dev, scenes: np.ndarray, profile: dict) -> dict:
    """Phase 6: the same engine at f32 on dev and on the CPU, 2 frames."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = {**profile, "compute_dtype": "float32"}
    engs = [RecognitionEngine(load_config(**f32), device=d) for d in (dev, "cpu")]
    batch = tick_batch(scenes, 0)
    ref = engs[1].process_frames(batch, fmt="yuv420")
    if not ref["valid"].any():
        raise AssertionError("the CPU engine found no face in the parity frames")
    # enrol each face at its own norm (an empty slot's zero query is nearest
    # to the shortest entry; equal norms would make that a rounding tie)
    embs = ref["embeddings"][ref["valid"]]
    embs = embs * np.linspace(1.0, 0.8, len(embs), dtype=np.float32)[:, None]
    decoys = np.random.default_rng(SEED).normal(size=(3, embs.shape[1])).astype(np.float32)
    for eng in engs:
        for n, e in enumerate([*embs, *decoys]):
            eng.gallery.add(f"id{n}", e)
    res = [eng.fetch(eng.submit_encoded(DeltaEncoder(block_bytes=128).encode(batch))) for eng in engs]
    got, want = res
    for key in ("valid", "count", "best_idx"):
        if not np.array_equal(got[key], want[key]):
            raise AssertionError(f"cuda and cpu engines differ in {key}")
    v = want["valid"]
    errs = {key: float(np.abs(got[key][v] - want[key][v]).max())
            for key in ("boxes", "landmarks", "scores", "best_distance", "fake_prob", "quality")}
    if not errs["boxes"] <= 1e-2:
        raise AssertionError(f"cuda and cpu boxes differ by {errs['boxes']} px")
    return dict(faces=int(v.sum()), max_abs_err=errs)


# --- main --------------------------------------------------------------------

def gpu_name_and_limit() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = gpu_name_and_limit()
    say("device", f"{kind} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"devices {torch.cuda.device_count()}")
    print(smi, flush=True)

    t0 = time.perf_counter()
    built = cuda_build.build()
    say("build", f"nvcc sm_90a into {cuda_build.BUILD_DIR}, one process a kernel: "
        + (", ".join(f"{k} {v:.1f} s" for k, v in built.items()) or "all already built")
        + f"; {time.perf_counter() - t0:.1f} s in all")

    scenes = render_scenes(FRAMES, PROFILE["det_size"], SEED)
    frames = torch.from_numpy(scenes).to(dev)
    checks = {
        "detection_head": check_detection_head(dev),
        "warp_crops": check_warp_crops(dev, frames),
        "greedy_nms": check_greedy_nms(dev, 512),
    }
    k256 = check_greedy_nms(dev, 256)
    for name, c in [*checks.items(), ("greedy_nms", k256)]:
        say("kernels", f"{name} {c['shape']}: equal to plain (max abs err {c['max_abs_err']:.3g}); "
            f"kernel {c['ms'] * 1e3:.1f} us, bound {c['bound_ms'] * 1e3:.3f} us by {c['bound_by']}, "
            f"plain {c['plain_ms'] * 1e3:.1f} us"
            + (f", grid_sample {c['library_ms'] * 1e3:.1f} us (max abs diff "
               f"{c['library_max_abs_err']:.3g})" if c["library_ms"] is not None else ""))
    say("kernels", "all three kernels equal their plain versions")

    scan = run_scan(dev, scenes, PROFILE, TICKS, WARM)
    say("engine", f"default profile, {FRAMES} x 640 I420 delta stream, {TICKS} ticks "
        f"after the keyframe: {scan['batches']} batches, launches {scan['launches']}")
    say("engine", f"steady state over {TICKS + 1 - WARM} ticks (submit then fetch): "
        f"{scan['frames_per_s']:.1f} frames/s, {scan['faces_per_s']:.1f} faces/s, "
        f"{scan['faces_per_batch']:.2f} faces/batch, {scan['ms_per_batch']:.2f} ms/batch")
    say("engine", "stage ms (device, median): "
        + ", ".join(f"{k} {v:.3f}" for k, v in scan["stage_ms"].items()))
    say("engine", f"resident batch == apply_host; enrolled face of frame "
        f"{scan['enrolled_frame']} matched at distance {scan['enrolled_distance']:.4f}")

    nms = run_nms_engine(dev, scenes, PROFILE)
    say("nms", f"pre_nms_topk=512: launches {nms['launches']}, {nms['faces']} faces")

    par = run_parity(dev, scenes[:2], PROFILE)
    say("parity", f"f32, TF32 off, 2 frames, {par['faces']} faces: valid, count, best_idx "
        "equal on cuda and cpu; max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in par["max_abs_err"].items()))

    counts = {**scan["launches"], "greedy_nms": nms["launches"]["greedy_nms"]}
    rows = []
    for name, (_, source, replaces) in KERNELS.items():
        c = checks[name]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
