"""Device-resident embedding gallery (port of ``frp_tpu/engine/gallery.py``).

A padded [capacity, D] matrix plus a validity mask on the engine's device,
with names on the host. Capacity grows by doubling; removal swaps the last
row into the freed slot so the valid rows stay contiguous. An engine over a
mesh takes a copy of the device view for each data position's device
(``device_views``), made again after the gallery changes.
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
        self._copies: dict = {}  # other devices' copies of _device
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

    def load_entries(self, entries: dict) -> int:
        """Bulk hydrate {name: embedding} (startup path)."""
        count = 0
        for name, emb in entries.items():
            try:
                self.add(name, emb)
                count += 1
            except (ValueError, TypeError):
                continue
        return count

    def load_matrix(self, names: list[str], matrix: np.ndarray) -> int:
        """Vectorized bulk hydrate from a [N, D] matrix — the per-entry path
        costs a Python iteration per identity, which matters at large gallery
        sizes. New names only; rows whose name already exists are skipped
        (use add() to overwrite)."""
        m = np.asarray(matrix, np.float32)
        if m.ndim != 2 or m.shape[1] != self.embed_dim:
            raise ValueError(f"matrix shape {m.shape} != [N, {self.embed_dim}]")
        if len(names) != m.shape[0]:
            raise ValueError("names/matrix length mismatch")
        with self._lock:
            seen: set = set()
            fresh = []
            for i, n in enumerate(names):
                # skip names already enrolled AND duplicates within the batch
                # (two live rows under one name would orphan one on remove)
                if n in self._index or n in seen:
                    continue
                seen.add(n)
                fresh.append((n, i))
            if not fresh:
                return 0
            base = len(self._names)
            self._grow(base + len(fresh))
            rows = np.fromiter((i for _, i in fresh), np.int64, len(fresh))
            self._host[base : base + len(fresh)] = m[rows]
            self._valid[base : base + len(fresh)] = True
            for k, (n, _) in enumerate(fresh):
                self._names.append(n)
                self._index[n] = base + k
            self._device = None
            self._version += 1
            return len(fresh)

    def device_arrays(self):
        """(matrix [capacity, D], valid [capacity]) as tensors on the
        gallery's device. They are copies, so later edits of the host arrays
        never reach a batch already submitted."""
        with self._lock:
            if self._device is None:
                self._device = (
                    torch.from_numpy(self._host.copy()).to(self.device),
                    torch.from_numpy(self._valid.copy()).to(self.device),
                )
                self._device_names = list(self._names)
                self._copies = {}
            return self._device

    def device_view(self):
        """(matrix, valid, names) — the names list is positionally tied to
        these exact device tensors: resolve match indices of an in-flight
        batch against it, never against live state (swap-remove reassigns
        slots)."""
        with self._lock:
            mat, valid = self.device_arrays()
            return mat, valid, self._device_names

    def device_views(self, devices: list):
        """([(matrix, valid) on each of ``devices``], names): one snapshot of
        the gallery for every data position of a batch, so that all of a
        batch's shards match against the same version and the names list
        stays tied to what they matched. A device other than the gallery's
        gets a copy of its view, kept until the gallery changes."""
        with self._lock:
            base = self.device_arrays()
            views = []
            for d in devices:
                d = torch.device(d)
                if d == self.device:
                    views.append(base)
                    continue
                got = self._copies.get(d)
                if got is None:
                    got = self._copies[d] = (base[0].to(d), base[1].to(d))
                views.append(got)
            return views, self._device_names

    def host_arrays(self):
        """(matrix [N, D] of the enrolled rows, names), host copies."""
        with self._lock:
            n = len(self._names)
            return self._host[:n].copy(), list(self._names)

    def name_of(self, idx: int) -> str | None:
        with self._lock:
            return self._names[idx] if 0 <= idx < len(self._names) else None
