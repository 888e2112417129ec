"""ctypes bindings of the port's host library ``csrc/framepack.cpp`` (a copy
of ``frp_tpu/utils/native.py``): the fused letterbox + BGR->I420 batch
packer, the block-sparse delta search and the changed-band detector.

The library is the port's own: ``ops/cuda_build.py::build_host`` compiles
``frp_tpu_torch/csrc/framepack.cpp`` with g++ at the first call into
``build/frp_tpu_torch/``, named by a hash of the source and flags. This is
host code, not a device kernel: where no compiler is found or the build
fails, every function here returns None (logged once) and the callers in
``engine/batching.py`` take their numpy copies, which give the same bytes.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading

import numpy as np

from frp_tpu_torch.ops import cuda_build
from frp_tpu_torch.utils.logger import get_logger

logger = get_logger("frp.utils.native")

VERSION = 4

_lock = threading.Lock()
_lib = None
_tried = False


def get_framepack():
    """The loaded library handle, built first if needed, or None when it
    cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(cuda_build.build_host("framepack"))
            lib.framepack_version.restype = ctypes.c_int
            version = lib.framepack_version()
            if version != VERSION:
                raise RuntimeError(f"framepack version {version}, expected {VERSION}")
            lib.framepack_letterbox_i420_rows.restype = None
            lib.framepack_letterbox_i420_rows.argtypes = [
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int,
            ]
            lib.framepack_dirty_bands.restype = ctypes.c_int
            lib.framepack_dirty_bands.argtypes = [
                ctypes.c_void_p,   # cur
                ctypes.c_void_p,   # prev (updated in place at dirty bands)
                ctypes.c_int,      # h
                ctypes.c_long,     # row_bytes
                ctypes.c_int,      # band
                ctypes.c_void_p,   # flags out [nbands] uint8
            ]
            lib.framepack_delta_blocks.restype = ctypes.c_int
            lib.framepack_delta_blocks.argtypes = [
                ctypes.c_void_p,   # cur
                ctypes.c_void_p,   # prev
                ctypes.c_int,      # n
                ctypes.c_long,     # frame_bytes
                ctypes.c_int,      # block
                ctypes.c_int,      # cap
                ctypes.c_void_p,   # idx out
                ctypes.c_void_p,   # blocks out
                ctypes.c_int,      # n_threads
            ]
            _lib = lib
        except (OSError, AttributeError, RuntimeError, subprocess.SubprocessError) as e:
            logger.info("framepack unavailable (%s); using the numpy copies", e)
            _lib = None
        return _lib


def library_path() -> str | None:
    """Where the loaded library lies (None when it did not load)."""
    return cuda_build.host_library_path("framepack") if get_framepack() is not None else None


def letterbox_i420_batch(
    frames: list[np.ndarray], size: int, n_threads: int = 4,
    rows: int | None = None,
):
    """Fused native path: list of HxWx3 BGR uint8 -> ([N, rows*3//2, size]
    I420 uint8, scales [N], offsets [N, 2] in full-square coordinates).
    ``rows`` < size packs only the active letterbox area (the engine's
    ingest stage pads the rest on device). Returns None when the native
    library is unavailable (the caller packs with
    ``engine.batching.letterbox_i420``)."""
    lib = get_framepack()
    if lib is None or not frames:
        return None
    rows = size if rows is None else rows
    n = len(frames)
    contiguous = [np.ascontiguousarray(f, dtype=np.uint8) for f in frames]
    for f in contiguous:
        if f.ndim != 3 or f.shape[2] != 3:
            raise ValueError(f"frames must be HxWx3, got {f.shape}")
    ptrs = (ctypes.c_void_p * n)(
        *[f.ctypes.data_as(ctypes.c_void_p).value for f in contiguous]
    )
    heights = (ctypes.c_int * n)(*[f.shape[0] for f in contiguous])
    widths = (ctypes.c_int * n)(*[f.shape[1] for f in contiguous])
    out = np.empty((n, rows * 3 // 2, size), np.uint8)
    scales = np.empty((n,), np.float32)
    offsets = np.empty((n, 2), np.float32)
    lib.framepack_letterbox_i420_rows(
        ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)),
        heights,
        widths,
        n,
        size,
        rows,
        out.ctypes.data_as(ctypes.c_void_p),
        scales.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_threads,
    )
    return out, scales, offsets


def delta_blocks(
    cur: np.ndarray,
    prev: np.ndarray,
    block: int,
    cap: int,
    idx: np.ndarray | None = None,
    blocks: np.ndarray | None = None,
    n_threads: int = 4,
) -> int | None:
    """Native block-sparse temporal delta.

    cur/prev: [B, NBYTES] uint8, C-contiguous (NBYTES % block == 0). With
    cap == 0 this is a count-only pass returning the max changed-block count
    across frames; with cap > 0 it fills idx [B, cap] int32 (-1 padded) and
    blocks [B, cap, block] uint8. Returns None when the native library is
    unavailable (the caller takes its numpy copy,
    ``engine.batching.changed_blocks``)."""
    lib = get_framepack()
    if lib is None:
        return None
    b, nbytes = cur.shape
    if not (prev.shape == cur.shape and nbytes % block == 0
            and cur.dtype == prev.dtype == np.uint8
            and cur.flags.c_contiguous and prev.flags.c_contiguous):
        raise ValueError("cur and prev must be equal-shape C-contiguous uint8 [B, NBYTES], "
                         "NBYTES a multiple of the block")
    if cap > 0 and not (idx is not None and blocks is not None
                        and idx.shape == (b, cap) and idx.dtype == np.int32
                        and blocks.shape == (b, cap, block) and blocks.dtype == np.uint8
                        and idx.flags.c_contiguous and blocks.flags.c_contiguous):
        raise ValueError("the fill pass needs idx int32 [B, cap] and blocks uint8 [B, cap, block]")
    return int(
        lib.framepack_delta_blocks(
            cur.ctypes.data_as(ctypes.c_void_p),
            prev.ctypes.data_as(ctypes.c_void_p),
            b,
            nbytes,
            block,
            cap,
            idx.ctypes.data_as(ctypes.c_void_p) if cap > 0 else None,
            blocks.ctypes.data_as(ctypes.c_void_p) if cap > 0 else None,
            n_threads,
        )
    )


def dirty_bands(cur: np.ndarray, prev: np.ndarray, band: int = 16) -> list | None:
    """Row bands of ``cur`` that differ from ``prev`` (both [H, W, C] uint8,
    C-contiguous, same shape); ``prev`` is updated IN PLACE at the dirty
    bands so it tracks the last-seen frame. Returns a merged list of
    half-open (y0, y1) source row bands, or None when the native library is
    unavailable (callers then treat everything as dirty)."""
    lib = get_framepack()
    if lib is None:
        return None
    if not (cur.shape == prev.shape and cur.dtype == prev.dtype == np.uint8
            and cur.flags.c_contiguous and prev.flags.c_contiguous):
        raise ValueError("cur and prev must be equal-shape C-contiguous uint8 frames")
    h = cur.shape[0]
    row_bytes = cur.nbytes // max(1, h)
    nbands = -(-h // band)
    flags = np.zeros(nbands, np.uint8)
    n = int(lib.framepack_dirty_bands(
        cur.ctypes.data_as(ctypes.c_void_p),
        prev.ctypes.data_as(ctypes.c_void_p),
        h, row_bytes, band,
        flags.ctypes.data_as(ctypes.c_void_p),
    ))
    if n == 0:
        return []
    out: list = []
    for i in np.flatnonzero(flags):
        y0, y1 = int(i) * band, min(h, (int(i) + 1) * band)
        if out and out[-1][1] == y0:
            out[-1] = (out[-1][0], y1)  # merge adjacent bands
        else:
            out.append((y0, y1))
    return out
