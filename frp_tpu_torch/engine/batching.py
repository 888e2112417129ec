"""Host-side batching for the PyTorch port: the letterbox, the I420
active-row ladder and the block-sparse temporal delta encoder (a copy of the
numpy parts of ``frp_tpu/engine/batching.py``; the native changed-block
search is not ported yet, and the numpy search gives the same payloads).

Letterboxing uses cv2 where it is installed and a numpy nearest resize where
it is not, exactly as the JAX package does.
"""

from __future__ import annotations

import itertools
import os

import numpy as np

try:
    import cv2
except ImportError:  # the card machine has no cv2
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


# ---------------------------------------------------------------------------
# temporal delta transfer: ship only the blocks that changed
# ---------------------------------------------------------------------------

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
        changed = (flat != self._prev).reshape(b, nblocks, self.block).any(axis=2)
        max_changed = int(changed.sum(axis=1).max()) if b else 0
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
        fb = flat.reshape(b, nblocks, self.block)
        for i in range(b):
            ci = np.flatnonzero(changed[i])
            idx[i, : len(ci)] = ci
            blocks[i, : len(ci)] = fb[i, ci]
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
