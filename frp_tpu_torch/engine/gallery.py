"""Device-resident embedding gallery (port of ``frp_tpu/engine/gallery.py``).

A padded [capacity, D] matrix plus a validity mask on the engine's device,
with names on the host. Capacity grows by doubling; removal swaps the last
row into the freed slot so the valid rows stay contiguous.
"""

from __future__ import annotations

import threading

import numpy as np
import torch


class DeviceGallery:
    """Thread-safe padded gallery: names on host, matrix on ``device``."""

    MIN_CAPACITY = 128

    def __init__(self, embed_dim: int = 128, capacity: int | None = None, device="cpu"):
        self.embed_dim = embed_dim
        self.device = torch.device(device)
        self._lock = threading.RLock()
        self._names: list[str] = []
        self._index: dict[str, int] = {}
        self._capacity = capacity or self.MIN_CAPACITY
        self._host = np.zeros((self._capacity, embed_dim), np.float32)
        self._valid = np.zeros((self._capacity,), bool)
        self._device = None  # lazily materialized (matrix, valid) pair
        self._device_names: list[str] = []  # names snapshot tied to _device
        self._version = 0

    def __len__(self) -> int:
        return len(self._names)

    @property
    def names(self) -> list[str]:
        with self._lock:
            return list(self._names)

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def version(self) -> int:
        return self._version

    def _grow(self, need: int):
        cap = self._capacity
        while cap < need:
            cap *= 2
        if cap != self._capacity:
            host = np.zeros((cap, self.embed_dim), np.float32)
            valid = np.zeros((cap,), bool)
            host[: self._capacity] = self._host
            valid[: self._capacity] = self._valid
            self._capacity, self._host, self._valid = cap, host, valid

    def add(self, name: str, embedding) -> None:
        emb = np.asarray(embedding, np.float32).reshape(-1)
        if emb.shape[0] != self.embed_dim:
            raise ValueError(
                f"embedding dim {emb.shape[0]} != gallery dim {self.embed_dim}"
            )
        with self._lock:
            if name in self._index:
                slot = self._index[name]
            else:
                slot = len(self._names)
                self._grow(slot + 1)
                self._names.append(name)
                self._index[name] = slot
            self._host[slot] = emb
            self._valid[slot] = True
            self._device = None
            self._version += 1

    def remove(self, name: str) -> bool:
        with self._lock:
            if name not in self._index:
                return False
            slot = self._index.pop(name)
            last = len(self._names) - 1
            if slot != last:  # swap-remove keeps the valid block contiguous
                last_name = self._names[last]
                self._names[slot] = last_name
                self._index[last_name] = slot
                self._host[slot] = self._host[last]
            self._names.pop()
            self._host[last] = 0
            self._valid[last] = False
            self._device = None
            self._version += 1
            return True

    def get(self, name: str) -> np.ndarray | None:
        with self._lock:
            slot = self._index.get(name)
            return None if slot is None else self._host[slot].copy()

    def clear(self) -> None:
        with self._lock:
            self._names.clear()
            self._index.clear()
            self._host[:] = 0
            self._valid[:] = False
            self._device = None
            self._version += 1

    def device_view(self):
        """(matrix [capacity, D], valid [capacity], names) — the names list
        is positionally tied to these exact device tensors: resolve match
        indices of an in-flight batch against it, never against live state
        (swap-remove reassigns slots). The tensors are copies, so later
        edits of the host arrays never reach a batch already submitted."""
        with self._lock:
            if self._device is None:
                self._device = (
                    torch.from_numpy(self._host.copy()).to(self.device),
                    torch.from_numpy(self._valid.copy()).to(self.device),
                )
                self._device_names = list(self._names)
            return (*self._device, self._device_names)

    def name_of(self, idx: int) -> str | None:
        with self._lock:
            return self._names[idx] if 0 <= idx < len(self._names) else None
