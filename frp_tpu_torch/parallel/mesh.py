"""Device meshes and the process-group bring-up (port of
``frp_tpu/parallel/mesh.py``).

A mesh is a [data, model] grid of positions. Two kinds, following PyTorch's
idiom rather than JAX's single global program:

* a single-process mesh (``make_mesh``): one process drives every position,
  each a ``torch.device``; the serving engine and the FL service's combine
  run over it. A device may be repeated: two positions on one card (or on
  the CPU) are two replicas there.
* a process mesh (``make_global_mesh``): one process a position, joined by
  ``torch.distributed``; the trainers run over it. Its data and model
  process groups come from ``init_device_mesh``.

``distributed_initialize`` brings up ``torch.distributed`` from arguments or
the environment (the ``jax.distributed`` contract of the JAX package, with
torchrun's variables in place of JAX's); alone, it touches nothing.
"""

from __future__ import annotations

import os
import socket
import zlib
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the device of this process's position, set by distributed_initialize:
# torch.distributed's default group is process state, and so is its device
_PROCESS_DEVICE: torch.device | None = None


class Mesh:
    """A [n_data, n_model] grid of positions. ``devices`` is a numpy object
    array of ``torch.device`` (``mesh.devices.size`` and
    ``mesh.shape[DATA_AXIS]`` read as in JAX). A process mesh also holds
    ``ranks``, the global rank of each position, and its process groups
    (``get_group``); ``device`` and ``position`` are then this process's."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, devices: np.ndarray, ranks: np.ndarray | None = None, device_mesh=None):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is a 2-D grid of positions, got shape {devices.shape}")
        self.devices = devices
        self.ranks = ranks
        self._device_mesh = device_mesh

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: int(self.devices.shape[0]), MODEL_AXIS: int(self.devices.shape[1])}

    @property
    def is_process_mesh(self) -> bool:
        return self.ranks is not None

    @property
    def position(self) -> tuple[int, int]:
        """(data, model) index of this process's position (process mesh)."""
        if self.ranks is None:
            raise ValueError("a single-process mesh has no position of its own")
        i, j = np.argwhere(self.ranks == dist.get_rank())[0]
        return int(i), int(j)

    @property
    def device(self) -> torch.device:
        """This process's device on a process mesh; the first position's on
        a single-process one."""
        if self.ranks is None:
            return self.devices[0, 0]
        return self.devices[self.position]

    def get_group(self, axis: str):
        """The process group of this process's row (``MODEL_AXIS``) or
        column (``DATA_AXIS``) of the grid."""
        if self._device_mesh is None:
            raise ValueError("a single-process mesh has no process groups")
        return self._device_mesh.get_group(axis)


def _env_int(*names: str) -> int | None:
    for name in names:
        raw = os.getenv(name)
        if raw:
            return int(raw)
    return None


def _process_device(device=None, process_id: int = 0) -> torch.device:
    """The device of this process's position: the one named, else the card
    of this process's local rank, raising without a card. The local rank is
    torchrun's LOCAL_RANK, or else the process id modulo the host's card
    count: ranks are process-major, one card a process, and every host
    holds as many (``global_grid``'s guards)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: a process's position is a card unless "
                           "device='cpu' is given")
    local = _env_int("LOCAL_RANK")
    return torch.device("cuda", process_id % torch.cuda.device_count() if local is None else local)


def distributed_initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device=None,
) -> dict:
    """Initialize torch.distributed from arguments or the environment,
    idempotently.

    Env contract (the JAX package's, with torchrun's names as the aliases):
      FRP_COORDINATOR   "host:port" of process 0 (MASTER_ADDR:MASTER_PORT
                        also honored); a "file://" or "tcp://" URL is taken
                        as the init method as it is
      FRP_NUM_PROCESSES / FRP_PROCESS_ID (WORLD_SIZE / RANK also honored)
      FRP_DIST_TIMEOUT  seconds the bring-up and every collective may wait
                        (60), so a wrong address fails instead of hanging
    ``device`` is this process's position (``_process_device``: the card of
    its local rank unless named); the backend is nccl on a card and gloo on
    the CPU unless ``backend`` names one. Returns {enabled, process_id,
    num_processes, local_devices, global_devices}: one position a process.
    Without a coordinator and without a group it returns enabled=False and
    touches neither torch.distributed nor the card."""
    global _PROCESS_DEVICE
    if coordinator is None:
        coordinator = os.getenv("FRP_COORDINATOR")
        if coordinator is None and os.getenv("MASTER_ADDR") and os.getenv("MASTER_PORT"):
            coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None:
        num_processes = _env_int("FRP_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("FRP_PROCESS_ID", "RANK")
    already = dist.is_available() and dist.is_initialized()
    if coordinator is None and not already:
        return {"enabled": False, "process_id": 0, "num_processes": 1,
                "local_devices": None, "global_devices": None}
    if not already:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs the number of processes and this process's "
                             "id (FRP_NUM_PROCESSES, FRP_PROCESS_ID)")
        dev = _process_device(device, process_id)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(dev)
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=init, world_size=num_processes, rank=process_id,
            timeout=timedelta(seconds=int(os.getenv("FRP_DIST_TIMEOUT", "60"))))
        _PROCESS_DEVICE = dev
    return {
        "enabled": True,
        "process_id": dist.get_rank(),
        "num_processes": dist.get_world_size(),
        "local_devices": 1,
        "global_devices": dist.get_world_size(),
    }


def _gather_rows(row: list[int], device: torch.device) -> np.ndarray:
    """Every process's ``row`` of ints, [world, len(row)], through one
    all_reduce (the collective every backend takes on every device)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    buf = torch.zeros((world, len(row)), dtype=torch.int64, device=device)
    buf[rank] = torch.tensor(row, dtype=torch.int64)
    dist.all_reduce(buf)
    return buf.cpu().numpy()


def global_grid(hosts: list, n_model: int) -> np.ndarray:
    """The [n_data, n_model] grid of global ranks, process-major, for the
    processes' hosts (``hosts[rank]``), with JAX's two guards: every host
    holds the same number of positions, and the model axis divides it, so
    that a model row never straddles two hosts (its collectives ride the
    host's own links)."""
    counts: dict = {}
    for h in hosts:
        counts[h] = counts.get(h, 0) + 1
    if len(set(counts.values())) > 1:
        raise ValueError(
            f"heterogeneous device counts per process {counts}: "
            "the (data, model) reshape would straddle hosts")
    per_host = counts[hosts[0]]
    if n_model > per_host or per_host % n_model:
        raise ValueError(
            f"model axis {n_model} must divide local device count {per_host} "
            "(TP must not cross hosts)")
    grid = np.arange(len(hosts)).reshape(len(hosts) // n_model, n_model)
    for row in grid:
        if len({hosts[r] for r in row}) > 1:
            raise ValueError(f"ranks {row.tolist()} of one model row are on several hosts: "
                             "start each host's processes with consecutive ranks")
    return grid


def make_global_mesh(n_model: int = 1) -> Mesh:
    """The process mesh over every process of the group: one position a
    process, process-major, the model axis within a host. Call
    ``distributed_initialize()`` first on every process."""
    if not (dist.is_available() and dist.is_initialized()) or _PROCESS_DEVICE is None:
        raise RuntimeError("make_global_mesh needs distributed_initialize() first")
    dev = _PROCESS_DEVICE
    host = zlib.crc32(socket.gethostname().encode())
    rows = _gather_rows([host, int(dev.type == "cuda"), -1 if dev.index is None else dev.index], dev)
    grid = global_grid(rows[:, 0].tolist(), n_model)
    devices = np.empty(grid.shape, dtype=object)
    for idx, r in np.ndenumerate(grid):
        kind, index = rows[r, 1], rows[r, 2]
        devices[idx] = torch.device("cuda", int(index)) if kind else torch.device("cpu")
    from torch.distributed.device_mesh import init_device_mesh

    device_mesh = init_device_mesh(dev.type, grid.shape, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(devices, ranks=grid, device_mesh=device_mesh)


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None) -> Mesh:
    """A single-process (data, model) mesh over this process's devices.

    Defaults: every local card on the data axis, model axis 1; no card
    raises. An explicit ``devices`` list may repeat a device: several
    positions on one card, or on the CPU, as the tests and the one-card
    smoke run give them."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=[...] to build a "
                               "mesh over other devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_model
    use = n_data * n_model
    if use == 0 or use > len(devices):
        raise ValueError(f"a {n_data} x {n_model} mesh needs {use} devices, have {len(devices)}")
    grid = np.empty((n_data, n_model), dtype=object)
    for k, d in enumerate(devices[:use]):
        grid[k // n_model, k % n_model] = d
    return Mesh(grid)


def data_rows(n: int, mesh: Mesh, what: str = "batch") -> list[slice]:
    """Contiguous equal row slices of an n-row batch, one for each data
    position (JAX's ``data_sharding``: rows must divide the data axis)."""
    n_data = mesh.shape[DATA_AXIS]
    if n % n_data:
        raise ValueError(f"a {what} of {n} rows does not divide the mesh's data axis of "
                         f"{n_data} positions")
    k = n // n_data
    return [slice(i * k, (i + 1) * k) for i in range(n_data)]


def serving_rows(n: int, mesh: Mesh) -> list[slice]:
    """The serving engine's split of an n-row batch over the data axis:
    contiguous, nearly equal row slices, the first ``n % n_data`` one row
    longer. Only positions that get a row are listed, so a batch of fewer
    rows than positions runs on the first ones (one empty slice for n = 0).
    The trainers and FedAvg keep ``data_rows``."""
    k, extra = divmod(n, mesh.shape[DATA_AXIS])
    out, at = [], 0
    for i in range(min(n, mesh.shape[DATA_AXIS])):
        size = k + (i < extra)
        out.append(slice(at, at + size))
        at += size
    return out or [slice(0, 0)]


def model_columns(n: int, mesh: Mesh) -> list[slice]:
    """Contiguous equal column slices of n columns, one for each model
    position (JAX's ``model_sharding``)."""
    n_model = mesh.shape[MODEL_AXIS]
    if n % n_model:
        raise ValueError(f"{n} columns do not divide the mesh's model axis of {n_model}")
    k = n // n_model
    return [slice(j * k, (j + 1) * k) for j in range(n_model)]
