"""Host-side batching for the PyTorch port (a copy of
``frp_tpu/engine/batching.py``): the letterbox, the I420 active-row ladder,
the batch builders and their change-hint caches, the mapping of results back
to cameras, and the block-sparse temporal delta encoder.

Letterboxing uses cv2 where it is installed and a numpy nearest resize where
it is not, exactly as the JAX package does. The port's host library
(``csrc/framepack.cpp`` through ``utils/native.py``, built with g++ at first
use) takes the paths the JAX package's native library takes: the I420 packer
without cv2, the changed-block search of the delta encoder, and the
changed-band detector for cameras without change hints. Where the library
cannot be built, the packer and the block search run their numpy copies
(``letterbox_i420``, ``changed_blocks``), which give the
same bytes, and the detector is off, as in the JAX package.
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass, field

import numpy as np

from frp_tpu_torch.utils.native import delta_blocks, dirty_bands, letterbox_i420_batch

try:
    import cv2
except ImportError:  # pragma: no cover - cv2 is installed where the port runs
    cv2 = None


def _resize_interp() -> str:
    """Serving decimation kernel: "linear" (default, 4.7x cheaper on the
    one-core host) or "area" (box filter). Read per call so processes that
    set FRP_RESIZE_INTERP after import (tests, embedded servers) are
    honored; unknown values fall back to linear with a one-time warning."""
    v = os.getenv("FRP_RESIZE_INTERP", "linear").lower()
    if v not in ("linear", "area"):
        if v not in _resize_interp._warned:
            _resize_interp._warned.add(v)
            import logging

            logging.getLogger("frp.engine").warning(
                "FRP_RESIZE_INTERP=%r is not 'linear'|'area'; using linear", v
            )
        return "linear"
    return v


_resize_interp._warned = set()  # type: ignore[attr-defined]


@dataclass
class BatchMeta:
    """Per-slot bookkeeping to map device results back to source streams."""

    cam_ids: list = field(default_factory=list)
    scales: np.ndarray | None = None   # [B] uniform letterbox scale
    offsets: np.ndarray | None = None  # [B, 2] (ox, oy) letterbox pad offsets
    frame_ok: np.ndarray | None = None  # [B] bool
    orig_hw: list = field(default_factory=list)


def letterbox(frame: np.ndarray, size: int, to_rgb: bool = False, rows: int | None = None):
    """Uniform-scale resize + pad to [rows or size, size].
    Returns (img, scale, (ox, oy)).

    ``rows`` < size produces the ACTIVE-AREA canvas: a 16:9 1080p frame only
    fills 640x360 of a det-640 square, so shipping 640x368 and letting the
    device pad the dead rows cuts host->device bytes by ~43% with identical
    detector input."""
    h, w = frame.shape[:2]
    rows = size if rows is None else rows
    s = min(size / w, rows / h)
    nw, nh = max(1, int(round(w * s))), max(1, int(round(h * s)))
    if cv2 is not None:
        # Downscale interpolation is a serving-throughput knob: INTER_LINEAR
        # (the default) is several times cheaper on the host than INTER_AREA's
        # box filter, with slight aliasing; the detector was trained on both.
        # FRP_RESIZE_INTERP=area restores the box filter.
        if s < 1.0:
            interp = (cv2.INTER_AREA
                      if _resize_interp() == "area" else cv2.INTER_LINEAR)
        else:
            interp = cv2.INTER_LINEAR
        resized = cv2.resize(frame, (nw, nh), interpolation=interp)
        if to_rgb:
            resized = cv2.cvtColor(resized, cv2.COLOR_BGR2RGB)
    else:  # numpy nearest fallback
        yi = np.clip((np.arange(nh) / s).astype(np.int64), 0, h - 1)
        xi = np.clip((np.arange(nw) / s).astype(np.int64), 0, w - 1)
        resized = frame[yi][:, xi]
        if to_rgb:
            resized = resized[..., ::-1]
    out = np.zeros((rows, size, 3), np.uint8)
    ox = (size - nw) // 2
    oy = (rows - nh) // 2
    out[oy : oy + nh, ox : ox + nw] = resized
    return out, s, (ox, oy)


def active_rows_for(shapes, size: int) -> int | None:
    """Pick the I420 active-row count for a batch of source frame shapes
    ((h, w) pairs). Returns None when the full square is needed (portrait /
    near-square sources) — callers then ship [size, size] as before.

    Snapped to a TWO-STEP LADDER (~0.575·size for 16:9, ~0.775·size for 4:3)
    rather than the exact need, so a serving process sees few batch shapes
    (the JAX package compiles one program per shape; the ladder is kept so
    both packages ship the same payloads). Both rungs are multiples of 16
    (the I420 plane reshape needs %4)."""
    need = 0
    for h, w in shapes:
        s = min(size / w, size / h)
        need = max(need, int(round(h * s)))
    ladder = [
        -(-int(size * 0.575) // 16) * 16,  # 16:9 and wider (368 @ det 640)
        -(-int(size * 0.775) // 16) * 16,  # up to 4:3 (496 @ det 640)
    ]
    for rows in ladder:
        if need <= rows < size:
            return rows
    return None


def build_batch(
    frames: dict, size: int, slots: int | None = None, bgr: bool = True
) -> tuple[np.ndarray, BatchMeta]:
    """Assemble {cam_id: frame or None} into a fixed device batch.

    Args:
        frames: mapping cam_id -> HxWx3 uint8 frame (BGR by default, as cv2
            delivers) or None for a dropped frame.
        size: letterbox target (the detector input size).
        slots: pad the batch to this many slots. Defaults to len(frames).
    """
    cam_ids = list(frames.keys())
    b = slots or max(1, len(cam_ids))
    batch = np.zeros((b, size, size, 3), np.uint8)
    meta = BatchMeta(
        cam_ids=cam_ids + [None] * (b - len(cam_ids)),
        scales=np.ones((b,), np.float32),
        offsets=np.zeros((b, 2), np.float32),
        frame_ok=np.zeros((b,), bool),
        orig_hw=[None] * b,
    )
    for i, cam in enumerate(cam_ids[:b]):
        frame = frames[cam]
        if frame is None or getattr(frame, "size", 0) == 0:
            continue
        img, s, (ox, oy) = letterbox(frame, size, to_rgb=bgr)
        batch[i] = img
        meta.scales[i] = s
        meta.offsets[i] = (ox, oy)
        meta.frame_ok[i] = True
        meta.orig_hw[i] = frame.shape[:2]
    return batch, meta


def letterbox_i420(frame: np.ndarray, size: int, rows: int):
    """One BGR frame -> ([rows*3/2, size] I420 uint8, scale, (ox, oy) in
    full-square coordinates): the letterbox and the BT.601 conversion in one
    pass, a numpy copy of ``csrc/framepack.cpp``'s ``pack_one`` (the packer
    where cv2 is missing and the library did not build), float32 arithmetic
    in the same order, so the same bytes. Bilinear samples at the
    destination pixel centres (x and y separable), studio-swing Y at every
    pixel, and U and V taken at the even rows and columns of the full
    square, not averaged."""
    f32 = np.float32
    h, w = frame.shape[:2]
    s = min(f32(size) / f32(w), f32(rows) / f32(h))
    nw = max(1, int(f32(w) * s + f32(0.5)))
    nh = max(1, int(f32(h) * s + f32(0.5)))
    ox, oy = (size - nw) // 2, (rows - nh) // 2
    inv = f32(1.0) / s

    def taps(n, limit):
        c = (np.arange(n, dtype=f32) + f32(0.5)) * inv - f32(0.5)
        c = np.maximum(f32(0.0), np.minimum(c, f32(limit - 1)))
        i0 = c.astype(np.int64)
        return i0, np.minimum(i0 + 1, limit - 1), c - i0.astype(f32)

    y0, y1, wy = taps(nh, h)
    x0, x1, wx = taps(nw, w)
    wx, wy = wx[None, :, None], wy[:, None, None]
    top, bot = frame[y0], frame[y1]  # gather the uint8 taps, then widen

    def tap(rows_, cols):
        return rows_[:, cols].astype(f32)

    img = ((tap(top, x0) * (f32(1) - wx) + tap(top, x1) * wx) * (f32(1) - wy)
           + (tap(bot, x0) * (f32(1) - wx) + tap(bot, x1) * wx) * wy)
    b, g, r = img[..., 0], img[..., 1], img[..., 2]

    def q(v):  # static_cast<int> truncates toward zero, then the clamp
        return np.clip(v.astype(np.int32), 0, 255).astype(np.uint8)

    yp = np.full((rows, size), 16, np.uint8)
    up = np.full((rows // 2, size // 2), 128, np.uint8)
    vp = np.full((rows // 2, size // 2), 128, np.uint8)
    yp[oy : oy + nh, ox : ox + nw] = q(
        f32(0.257) * r + f32(0.504) * g + f32(0.098) * b + f32(16.5))
    # chroma at the pixels whose full-square row and column are even
    cy, cx = slice(oy % 2, nh, 2), slice(ox % 2, nw, 2)
    cb, cg, cr = b[cy, cx], g[cy, cx], r[cy, cx]
    ry, rx = (oy + oy % 2) // 2, (ox + ox % 2) // 2
    up[ry : ry + cb.shape[0], rx : rx + cb.shape[1]] = q(
        -f32(0.148) * cr - f32(0.291) * cg + f32(0.439) * cb + f32(128.5))
    vp[ry : ry + cb.shape[0], rx : rx + cb.shape[1]] = q(
        f32(0.439) * cr - f32(0.368) * cg - f32(0.071) * cb + f32(128.5))
    out = np.concatenate([yp.reshape(-1), up.reshape(-1), vp.reshape(-1)])
    return out.reshape(rows * 3 // 2, size), s, (ox, oy + (size - rows) // 2)


def build_batch_i420(
    frames: dict, size: int, slots: int | None = None,
    active_rows: int | None = None,
) -> tuple[np.ndarray, BatchMeta]:
    """I420 variant of build_batch — halves the host->device bytes.

    ``active_rows`` ships only that many letterboxed rows per frame (the
    16:9 active area of a det square); the engine's ingest stage pads the
    dead rows back on device (black, identical to the host letterbox),
    cutting upload bytes by rows/size. Meta offsets are in FULL-square
    coordinates so decode/unmap are unchanged.

    Path selection: cv2 (letterbox + cvtColor) where it is installed, else
    the native packer (``utils/native.py::letterbox_i420_batch``), else its
    numpy copy ``letterbox_i420``; the last two give the same bytes. Device
    side decodes with ops.image.yuv420_to_rgb (engine fmt="yuv420").
    """
    cam_ids = list(frames.keys())
    b = slots or max(1, len(cam_ids))
    rows = size if active_rows is None else active_rows
    assert rows % 16 == 0 and rows <= size, rows
    oy_pad = (size - rows) // 2  # where the device places the active rows
    batch = np.zeros((b, rows * 3 // 2, size), np.uint8)
    batch[:, rows:, :] = 128  # empty slots = black (U=V=128)
    batch[:, :rows, :] = 16
    meta = BatchMeta(
        cam_ids=cam_ids + [None] * (b - len(cam_ids)),
        scales=np.ones((b,), np.float32),
        offsets=np.zeros((b, 2), np.float32),
        frame_ok=np.zeros((b,), bool),
        orig_hw=[None] * b,
    )
    live = [
        (i, frames[c])
        for i, c in enumerate(cam_ids[:b])
        if frames[c] is not None and getattr(frames[c], "size", 0) > 0
    ]
    if not live:
        return batch, meta
    if cv2 is not None:
        packed = []
        for _, frame in live:
            boxed, s, (ox, oy) = letterbox(frame, size, rows=rows)
            packed.append((cv2.cvtColor(boxed, cv2.COLOR_BGR2YUV_I420), s, (ox, oy + oy_pad)))
    else:
        native = letterbox_i420_batch([f for _, f in live], size, rows=rows)
        if native is not None:
            packed = list(zip(*native))
        else:
            packed = [letterbox_i420(np.ascontiguousarray(f, dtype=np.uint8), size, rows)
                      for _, f in live]
    for (i, frame), (img, s, off) in zip(live, packed):
        batch[i] = img
        meta.scales[i] = s
        meta.offsets[i] = off
        meta.frame_ok[i] = True
        meta.orig_hw[i] = frame.shape[:2]
    return batch, meta


def unmap_results(out: dict, meta: BatchMeta) -> list[dict]:
    """Convert padded device results into per-camera detection lists with
    boxes/landmarks back in original frame pixels."""
    results = []
    b, m = out["valid"].shape
    for i in range(b):
        cam = meta.cam_ids[i] if i < len(meta.cam_ids) else None
        if cam is None or not meta.frame_ok[i]:
            continue
        s = float(meta.scales[i])
        ox, oy = (float(v) for v in meta.offsets[i])
        faces = []
        for j in range(m):
            if not out["valid"][i, j]:
                continue
            box = out["boxes"][i, j].astype(np.float64)
            box = np.array(
                [
                    (box[0] - ox) / s,
                    (box[1] - oy) / s,
                    (box[2] - ox) / s,
                    (box[3] - oy) / s,
                ]
            )
            ldm = out["landmarks"][i, j].reshape(5, 2).astype(np.float64)
            ldm = (ldm - np.array([ox, oy])) / s
            face = {
                "box": box,
                "landmarks": ldm,
                "score": float(out["scores"][i, j]),
                "best_idx": int(out["best_idx"][i, j]),
                "best_distance": float(out["best_distance"][i, j]),
                "is_match": bool(out["is_match"][i, j]),
            }
            # packed results (engine.submit default / unpack_packed) carry
            # only the PACKED_LAYOUT columns — embeddings/topk are absent
            if "embeddings" in out:
                face["embedding"] = out["embeddings"][i, j]
            if "topk_idx" in out:
                face["topk_idx"] = out["topk_idx"][i, j]
                face["topk_distance"] = out["topk_distance"][i, j]
            if "fake_prob" in out:
                face["fake_prob"] = float(out["fake_prob"][i, j])
            if "quality" in out:
                face["quality"] = float(out["quality"][i, j])
            faces.append(face)
        results.append({"camera_id": cam, "faces": faces})
    return results


# ---------------------------------------------------------------------------
# change-hint letterboxing: redo only the bands a camera changed
# ---------------------------------------------------------------------------

class LetterboxCache:
    """Persistent per-camera letterboxed I420 frame updated from source
    dirty ROW BANDS (decoder change hints).

    Full letterbox+I420 of 8x1080p is the largest host cost of a scan, while
    a surveillance tick typically changes a small region per camera. Video
    decoders know which rows changed (H.264/HEVC macroblock info; the
    synthetic sources know their sprite rects), so the host can redo only
    the affected det-space bands: resize the source slab, convert that band,
    scatter it into the persistent I420 planes.

    Exactness: banded updates are BIT-IDENTICAL to the full path when the
    decimation stride k = 1/scale is an integer and the frame fills the
    full letterbox width (1080p->det640: k=3, 720p->det640: k=2 — the
    serving geometries); bilinear/area sampling for dest row j then reads
    only source rows [k*j, k*(j+1)), so a slab starting at source row k*j0
    reproduces the global grid. Any other geometry, a source-shape change,
    or dirty=None falls back to the full letterbox transparently.

    Hazard (the same class as a delta-transfer desync): hints that
    UNDER-report changes leave stale pixels in the cache forever — sources
    must over-report or pass None. update(dirty=None) is always a full
    rebuild; update(dirty=[]) means "nothing changed". Needs cv2:
    ``build_batch_i420_cached`` takes the full path without it.
    """

    def __init__(self, size: int, rows: int | None = None,
                 buf: np.ndarray | None = None):
        self.size = int(size)
        self.rows = int(rows) if rows else int(size)
        if buf is not None:
            assert buf.shape == (self.rows * 3 // 2, self.size), buf.shape
            assert buf.dtype == np.uint8 and buf.flags.c_contiguous
        # external buf (e.g. a batch slot) makes updates zero-copy: the
        # cache writes bands straight into the submit buffer
        self._buf = buf
        self._i420: np.ndarray | None = None  # [rows*3/2, size] uint8
        self._src_shape: tuple | None = None
        self._geo: tuple | None = None  # (scale, ox, oy, nh, k)
        # bands applied by the LAST update when it took the banded path;
        # None after a full rebuild (downstream delta hints must then diff
        # everything — see dirty_blocks)
        self.last_bands: list | None = None

    @property
    def frame(self) -> np.ndarray | None:
        """The cache's own I420 buffer (do NOT mutate)."""
        return self._i420

    @property
    def geometry(self) -> tuple | None:
        """(scale, ox, oy) of the letterbox, as letterbox() returns."""
        if self._geo is None:
            return None
        s, ox, oy, _nh, _k = self._geo
        return s, (ox, oy)

    def _full(self, frame) -> np.ndarray:
        boxed, s, (ox, oy) = letterbox(frame, self.size, rows=self.rows)
        if cv2 is None:  # banded path needs cv2 anyway; full fallback only
            raise RuntimeError("LetterboxCache requires cv2")
        conv = cv2.cvtColor(boxed, cv2.COLOR_BGR2YUV_I420)
        if self._buf is not None:
            np.copyto(self._buf, conv)
            self._i420 = self._buf
        else:
            self._i420 = conv
        self.last_bands = None
        self._src_shape = frame.shape
        h, w = frame.shape[:2]
        nh = max(1, int(round(h * s)))
        k = 1.0 / s
        exact = (
            abs(k - round(k)) < 1e-9
            and max(1, int(round(w * s))) == self.size  # full width, ox == 0
            and ox == 0
            and oy % 2 == 0
            and nh % 2 == 0            # chroma pairs never cross a band edge
            and h == nh * int(round(k))  # slabs never run short at the tail
        )
        self._geo = (s, ox, oy, nh, int(round(k)) if exact else None)
        return self._i420

    def update(self, frame: np.ndarray, dirty=None) -> np.ndarray:
        """frame: HxWx3 uint8 BGR; dirty: None = assume everything changed
        (full rebuild), or iterable of (y0, y1) SOURCE row bands that cover
        every changed pixel since the previous update. Returns the
        persistent [rows*3/2, size] I420 frame."""
        if (
            dirty is None
            or self._i420 is None
            or frame.shape != self._src_shape
            or self._geo is None
            or self._geo[4] is None
        ):
            return self._full(frame)
        s, _ox, oy, nh, k = self._geo
        size, rows = self.size, self.rows
        out = self._i420
        flat = out.reshape(-1)
        u_base = rows * size
        v_base = u_base + (rows // 2) * (size // 2)
        h = frame.shape[0]
        interp = (cv2.INTER_AREA if _resize_interp() == "area"
                  else cv2.INTER_LINEAR) if s < 1.0 else cv2.INTER_LINEAR
        for band in dirty:
            y0, y1 = int(band[0]), int(band[1])
            if y1 <= y0:
                continue
            j0, j1 = self._dest_band(y0, y1, nh, k)
            if j1 <= j0:
                continue
            slab = frame[j0 * k : min(h, j1 * k)]
            band_bgr = cv2.resize(slab, (size, j1 - j0), interpolation=interp)
            conv = cv2.cvtColor(band_bgr, cv2.COLOR_BGR2YUV_I420).reshape(-1)
            bh = j1 - j0
            # Y
            out[oy + j0 : oy + j1] = conv[: bh * size].reshape(bh, size)
            # U and V planes: contiguous flat runs in both buffers
            uq = (size // 2)
            cu0, cu1 = bh * size, bh * size + (bh // 2) * uq
            du0 = u_base + ((oy + j0) // 2) * uq
            flat[du0 : du0 + (bh // 2) * uq] = conv[cu0:cu1]
            dv0 = v_base + ((oy + j0) // 2) * uq
            flat[dv0 : dv0 + (bh // 2) * uq] = conv[cu1 : cu1 + (bh // 2) * uq]
        self.last_bands = [tuple(band) for band in dirty]
        return out

    @staticmethod
    def _dest_band(y0: int, y1: int, nh: int, k: int) -> tuple[int, int]:
        """Dest rows a source row band [y0, y1) influences — one-row slop on
        each side (cheap), snapped to even for the 2x2 chroma average."""
        j0 = max(0, (y0 // k - 1)) & ~1
        j1 = min(nh, -(-(y1 + k) // k) + 1)
        j1 = min(nh, (j1 + 1) & ~1)
        return j0, j1

    def banded_capable(self, frame) -> bool:
        """True when update(frame, dirty=...) would take the banded path."""
        return (
            self._i420 is not None
            and frame.shape == self._src_shape
            and self._geo is not None
            and self._geo[4] is not None
        )

    def dirty_blocks(self, block_bytes: int, bands: list | None = None):
        """Half-open (b0, b1) BLOCK ranges in the flattened I420 frame that
        cover the given source row bands (default: the LAST update's bands)
        — the delta-encoder hint for this frame. Returns None when the last
        update was a full rebuild or banded geometry is unavailable (the
        encoder must then diff every block)."""
        bands = self.last_bands if bands is None else bands
        if bands is None or self._geo is None or self._geo[4] is None:
            return None
        s, _ox, oy, nh, k = self._geo
        size, rows = self.size, self.rows
        u_base = rows * size
        v_base = u_base + (rows // 2) * (size // 2)
        out = []
        for y0, y1 in bands:
            j0, j1 = self._dest_band(int(y0), int(y1), nh, k)
            if j1 <= j0:
                continue
            uq = size // 2
            spans = (
                ((oy + j0) * size, (oy + j1) * size),
                (u_base + ((oy + j0) // 2) * uq,
                 u_base + ((oy + j1) // 2) * uq),
                (v_base + ((oy + j0) // 2) * uq,
                 v_base + ((oy + j1) // 2) * uq),
            )
            out.extend(
                (a // block_bytes, -(-z // block_bytes)) for a, z in spans
            )
        return out


class SourceChangeDetector:
    """Change hints for sources that can't provide them: diffs the raw
    source frame against the previous one in row bands of ``band`` rows
    (``utils/native.py::dirty_bands``, a memcmp a band) and updates its
    previous copy in place at the bands that changed. Used by
    build_batch_i420_cached as the automatic fallback when a source has no
    read_hints; off when the native library is missing (callers then run
    the full letterbox path)."""

    def __init__(self, band: int = 16):
        self.band = int(band)
        self._prev: np.ndarray | None = None
        self._disabled = False

    def hints(self, frame: np.ndarray) -> list | None:
        if self._disabled:
            return None
        if self._prev is None or self._prev.shape != frame.shape:
            self._prev = np.ascontiguousarray(frame).copy()
            return None  # first sight / geometry change: full rebuild
        bands = dirty_bands(np.ascontiguousarray(frame), self._prev, self.band)
        if bands is None:  # no native lib: stop paying the prev copies
            self._disabled = True
            self._prev = None
            return None
        return bands


def build_batch_i420_cached(
    frames: dict, size: int, state: dict, hints: dict | None = None,
    slots: int | None = None, active_rows: int | None = None,
) -> tuple[np.ndarray, BatchMeta]:
    """build_batch_i420 with per-camera LetterboxCaches persisted in
    ``state`` (an empty dict on first call, owned by the caller — the scan
    loop keeps one per router): cameras whose sources provide change hints
    ({cam_id: [(y0, y1), ...]}) re-letterbox only those source bands into
    their persistent batch slot. Any change to the camera set, slot layout,
    or active-rows rung rebuilds the state transparently (that scan runs
    the full path). Cameras without hints are diffed by a
    SourceChangeDetector a camera, which keeps a copy of the frame the slot
    was last built from: whenever the slot is built from anything else (the
    source's own hints, a full letterbox, a blanked outage) the detector is
    dropped, so its copy never lags the slot and a band that reverts can
    never be reported clean while the slot holds older pixels. Returns the
    PERSISTENT batch buffer — callers must finish reading it (encode/upload)
    before the next call. Without cv2 it is build_batch_i420, and ``state``
    stays empty."""
    cam_ids = list(frames.keys())
    b = slots or max(1, len(cam_ids))
    rows = size if active_rows is None else active_rows
    assert rows % 16 == 0 and rows <= size, rows
    if cv2 is None:
        return build_batch_i420(frames, size, slots=slots,
                                active_rows=active_rows)
    key = (tuple(cam_ids), b, rows, size)
    if state.get("key") != key:
        batch = np.zeros((b, rows * 3 // 2, size), np.uint8)
        batch[:, :rows, :] = 16
        batch[:, rows:, :] = 128
        state.clear()
        state.update(
            key=key, batch=batch,
            caches={c: LetterboxCache(size, rows, buf=batch[i])
                    for i, c in enumerate(cam_ids[:b])},
            live=set(),
        )
    batch = state["batch"]
    # per-slot delta-hint status for this scan: None = content changed
    # unpredictably (full diff), [] = slot untouched, cam_id = banded
    # update (resolve via delta_hints_for). A state reset rewrote every
    # slot -> the default [] below only survives for slots not touched
    # this scan AFTER at least one build, which is exactly when it's true.
    slot_status: list = ([None] * b if "slot_status" not in state
                         else [[] for _ in range(b)])
    state["slot_status"] = slot_status
    oy_pad = (size - rows) // 2
    meta = BatchMeta(
        cam_ids=cam_ids + [None] * (b - len(cam_ids)),
        scales=np.ones((b,), np.float32),
        offsets=np.zeros((b, 2), np.float32),
        frame_ok=np.zeros((b,), bool),
        orig_hw=[None] * b,
    )
    for i, cam in enumerate(cam_ids[:b]):
        frame = frames[cam]
        if frame is None or getattr(frame, "size", 0) == 0:
            if cam in state["live"]:
                # blank the stale slot; the cache content no longer matches
                # its buffer, so force a rebuild on the camera's return
                batch[i, :rows, :] = 16
                batch[i, rows:, :] = 128
                state["caches"][cam] = LetterboxCache(size, rows, buf=batch[i])
                state["live"].discard(cam)
                # the change detector's previous copy predates the outage;
                # on the camera's return it would under-report any band
                # that reverted to its pre-outage content, ghosting stale
                # pixels into the cache forever — drop it with the cache
                state.get("detectors", {}).pop(cam, None)
                slot_status[i] = None  # slot content changed (blanked)
            continue
        dirty = None if hints is None else hints.get(cam)
        detectors = state.setdefault("detectors", {})
        if dirty is None and state["caches"][cam].banded_capable(frame):
            # hintless source: compute hints by diffing the raw frame
            # against the detector's previous copy
            dirty = detectors.setdefault(cam, SourceChangeDetector()).hints(frame)
        else:
            # the slot is built from the source's hints or in full, not by
            # the detector: its previous copy would lag the slot, and a band
            # that later reverts to that copy would be reported clean while
            # the slot still holds the newer pixels
            detectors.pop(cam, None)
        state["caches"][cam].update(frame, dirty)
        slot_status[i] = (cam if state["caches"][cam].last_bands is not None
                          else None)
        s, (ox, oy) = state["caches"][cam].geometry
        meta.scales[i] = s
        meta.offsets[i] = (ox, oy + oy_pad)
        meta.frame_ok[i] = True
        meta.orig_hw[i] = frame.shape[:2]
        state["live"].add(cam)
    return batch, meta


def delta_hints_for(state: dict, block_bytes: int) -> list | None:
    """Per-slot block hints for DeltaEncoder.encode(batch, hints=...) on the
    batch build_batch_i420_cached just produced from ``state``: [] for
    untouched slots, block ranges for banded updates, None for slots whose
    content changed unpredictably (full rebuild / blanking / reset)."""
    statuses = state.get("slot_status")
    if statuses is None:
        return None
    caches = state.get("caches", {})
    out = []
    for status in statuses:
        if status is None or isinstance(status, list):
            out.append(status)
        else:  # cam id -> banded update; resolve to block ranges
            out.append(caches[status].dirty_blocks(block_bytes))
    return out


# ---------------------------------------------------------------------------
# temporal delta transfer: ship only the blocks that changed
# ---------------------------------------------------------------------------

def changed_blocks(cur: np.ndarray, prev: np.ndarray, block: int, cap: int,
                   idx: np.ndarray | None = None, blocks: np.ndarray | None = None) -> int:
    """The numpy copy of ``utils/native.py::delta_blocks`` (its plain
    version): the most changed `block`-byte blocks of any frame of cur
    against prev ([B, NBYTES] uint8); with cap > 0 also the first cap
    changed blocks of each frame into idx [B, cap] (-1 padded, as the
    caller allocates it) and blocks [B, cap, block]."""
    b = cur.shape[0]
    changed = (cur != prev).reshape(b, -1, block).any(axis=2)
    if cap > 0:
        fb = cur.reshape(b, -1, block)
        for i in range(b):
            ci = np.flatnonzero(changed[i])[:cap]
            idx[i, : len(ci)] = ci
            blocks[i, : len(ci)] = fb[i, ci]
    return int(changed.sum(axis=1).max()) if b else 0


class DeltaPayload(tuple):
    """A DeltaEncoder.encode() result: a plain ("raw", ...)/("delta", ...)
    tuple tagged with the producing encoder's identity and a per-encoder
    sequence number. The engine validates the tags in submit_encoded so two
    encoders interleaving payloads — or a dropped payload — raise loudly
    instead of silently reconstructing against the wrong resident batch.
    Unpacks/indexes exactly like the underlying tuple, so hand-built untagged
    tuples (precompile no-ops, tests) still work — they just skip validation.
    """

    def __new__(cls, data, enc_id: int, seq: int):
        self = super().__new__(cls, data)
        self.enc_id = enc_id
        self.seq = seq
        return self


class DeltaEncoder:
    """Block-sparse temporal delta coding for I420 batches.

    Surveillance frames are temporally redundant: between consecutive scans
    only the regions with motion change. The device keeps the previous
    reconstructed batch resident (engine delta stage); the host ships only
    the CHANGED fixed-size blocks (indices + payload) — a lossless, bit-exact
    reconstruction. Block-granular sparse update instead of RLE because a
    scatter of [cap, K]-byte blocks is one vectorized scatter on the device,
    while RLE decode is inherently sequential.

    Capacity ladder: per-batch capacity snaps to a four-rung ladder (1/16 .. 1/2 of the block count). Batches
    changing more than half their blocks ship raw (keyframe) — also the
    reset path for the first batch and any shape change. Wire cost per delta
    batch = cap * (K + 4) bytes vs rows*size*3/2 raw.
    """

    LADDER = (16, 8, 4, 2)  # denominators: cap = n_blocks/16 ... /2

    _next_id = itertools.count(1)  # distinct per-encoder identity tags

    def __init__(self, block_bytes: int = 512):
        self.block = int(block_bytes)
        self._prev: np.ndarray | None = None  # [B, NBYTES] last-shipped bytes
        self._enc_id = next(DeltaEncoder._next_id)
        self._seq = 0

    def reset(self) -> None:
        self._prev = None

    def _out(self, data) -> DeltaPayload:
        self._seq += 1
        return DeltaPayload(data, self._enc_id, self._seq)

    def encode(self, batch: np.ndarray, hints: list | None = None):
        """batch: [B, rows*3/2, size] uint8 -> ("raw", batch) or
        ("delta", idx [B, cap] int32 (-1 padded), blocks [B, cap, K] uint8).
        Updates internal previous-frame state either way.

        ``hints``: optional per-frame block hints (len B): entry i is None
        (unknown — diff every block of frame i) or a list of half-open
        (b0, b1) BLOCK ranges covering every possibly-changed block
        (LetterboxCache.dirty_blocks). TRUSTED, same contract as
        FrameSource.read_hints: an under-reporting hint ships stale blocks
        forever. With hints the encoder diffs (and copies into its
        previous-frame state) only the hinted ranges — the full-frame
        memcmp + 5.9 MB _prev copy disappear from the producer."""
        b = batch.shape[0]
        if b == 0:
            # degrade gracefully on an empty camera set (reshape(0, -1) is
            # invalid numpy and would crash the scan loop)
            return self._out(("raw", batch))
        flat = batch.reshape(b, -1)
        nbytes = flat.shape[1]
        if nbytes % self.block != 0:
            # keep device flatten/scatter shape-exact: no tail block
            self._prev = None
            return self._out(("raw", batch))
        nblocks = nbytes // self.block
        if self._prev is None or self._prev.shape != flat.shape:
            # COPY, never a view: ascontiguousarray of an already-contiguous
            # batch aliases the caller's buffer — a caller reusing a
            # preallocated batch would then compare each frame against
            # itself and ship empty deltas forever
            self._prev = flat.copy()
            return self._out(("raw", batch))
        flat = np.ascontiguousarray(flat)
        if hints is not None:
            return self._encode_hinted(batch, flat, nblocks, hints)
        search = delta_blocks
        max_changed = search(flat, self._prev, self.block, 0)
        if max_changed is None:  # no native lib: the numpy copy
            search = changed_blocks
            max_changed = search(flat, self._prev, self.block, 0)
        cap = None
        for denom in self.LADDER:
            if max_changed <= nblocks // denom:
                cap = nblocks // denom
                break
        if cap is None or cap == 0:
            self._prev = flat.copy()
            return self._out(("raw", batch))
        idx = np.full((b, cap), -1, np.int32)
        blocks = np.zeros((b, cap, self.block), np.uint8)
        search(flat, self._prev, self.block, cap, idx, blocks)
        self._prev = flat.copy()
        return self._out(("delta", idx, blocks))

    def _encode_hinted(self, batch, flat, nblocks: int, hints: list):
        b = flat.shape[0]
        fb = flat.reshape(b, nblocks, self.block)
        pb = self._prev.reshape(b, nblocks, self.block)
        per_frame: list[np.ndarray] = []
        max_changed = 0
        for i in range(b):
            hint = hints[i] if i < len(hints) else None
            if hint is None:
                ci = np.flatnonzero((fb[i] != pb[i]).any(axis=1))
            else:
                parts = []
                for r0, r1 in hint:
                    r0 = max(0, int(r0))
                    r1 = min(nblocks, int(r1))
                    if r1 <= r0:
                        continue
                    d = (fb[i, r0:r1] != pb[i, r0:r1]).any(axis=1)
                    parts.append(np.flatnonzero(d) + r0)
                ci = (np.unique(np.concatenate(parts)) if parts
                      else np.empty(0, np.int64))
            per_frame.append(ci)
            max_changed = max(max_changed, len(ci))
        cap = None
        for denom in self.LADDER:
            if max_changed <= nblocks // denom:
                cap = nblocks // denom
                break
        if cap is None or cap == 0:
            self._prev = flat.copy()
            return self._out(("raw", batch))
        idx = np.full((b, cap), -1, np.int32)
        blocks = np.zeros((b, cap, self.block), np.uint8)
        for i, ci in enumerate(per_frame):
            idx[i, : len(ci)] = ci
            blocks[i, : len(ci)] = fb[i, ci]
            pb[i, ci] = fb[i, ci]  # update _prev only where shipped
        return self._out(("delta", idx, blocks))

    @staticmethod
    def apply_host(prev_flat: np.ndarray, idx: np.ndarray, blocks: np.ndarray):
        """Reference host-side reconstruction (tests / non-device paths)."""
        out = prev_flat.copy()
        b, cap, k = blocks.shape
        fb = out.reshape(b, -1, k)
        for i in range(b):
            for j in range(cap):
                if idx[i, j] >= 0:
                    fb[i, idx[i, j]] = blocks[i, j]
        return out
