"""Process-mesh runs for the tests, the dry run and the smoke run: start
ranks with ``torch.multiprocessing`` (spawn), join them through a file
store, and run trainer steps over a process mesh.

    results = spawn_ranks(4, train_case, {"device": "cpu", "n_model": 2,
                                          "cases": {"arcface": {...}}})

``spawn_ranks`` returns what each rank's function returned, in rank order,
and raises with the rank's traceback when one fails. ``train_case`` builds
each trainer of its spec over ``make_global_mesh``, takes one step on the
spec's global batch and returns, on rank 0, the metrics and the state as
flat numpy arrays in the JAX package's layouts (``trainer_arrays``), the
column-split classifier and its momentum gathered whole.
``counted_collectives`` counts the collective calls a block makes by the
size of their group, and ``one_rank_groups`` builds trainers as the port
did before it dropped the groups of one rank (the reference that the
tests hold today's step to).
"""

from __future__ import annotations

import contextlib
import os
import pickle
import tempfile
import time
import traceback
import types
from queue import Empty

import torch


def _main(fn, rank: int, world: int, store: str, queue, args_path: str) -> None:
    try:
        with open(args_path, "rb") as f:
            args = pickle.load(f)  # written by spawn_ranks in the parent
        queue.put((rank, True, fn(rank, world, store, *args)))
    except BaseException:  # reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(world: int, fn, *args, timeout: float = 600) -> list:
    """fn(rank, world, store, *args) in `world` spawned processes; `store`
    is a fresh file path for ``distributed_initialize``'s "file://" init.
    Returns the ranks' results in rank order. The arguments reach the ranks
    through a file: through the start pipe, whose writer waits for the
    child to import its main module, they would start the ranks one after
    another."""
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as td:
        store, args_path = os.path.join(td, "store"), os.path.join(td, "args.pkl")
        with open(args_path, "wb") as f:
            pickle.dump(args, f)
        procs = [ctx.Process(target=_main, args=(fn, r, world, store, queue, args_path))
                 for r in range(world)]
        for p in procs:
            p.start()
        got: dict = {}
        deadline = time.monotonic() + timeout
        try:
            # drain the queue before joining: a rank blocks on a full pipe
            while len(got) < world:
                try:
                    rank, ok, value = queue.get(timeout=1.0)
                except Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0][0]} of {world} exited with code "
                                           f"{dead[0][1]} before it reported") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{world - len(got)} of {world} ranks did not report "
                                           f"in {timeout} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
                got[rank] = value
        finally:
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()) if len(got) == world else 1.0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world)]


def make_trainer(kind: str, mesh, **kwargs):
    """An ArcFace ("arcface"), spoof or detector trainer over `mesh`."""
    if kind == "arcface":
        from frp_tpu_torch.train.arcface import ArcFaceTrainer

        return ArcFaceTrainer(mesh=mesh, **kwargs)
    if kind == "spoof":
        from frp_tpu_torch.train.classifier import SpoofTrainer

        return SpoofTrainer(mesh=mesh, **kwargs)
    if kind == "detector":
        from frp_tpu_torch.train.detector import DetectorTrainer

        return DetectorTrainer(mesh=mesh, **kwargs)
    raise ValueError(f"unknown trainer {kind!r}")


BUFFERS = {"arcface": ("momentum_buffer",), "spoof": ("exp_avg", "exp_avg_sq"),
           "detector": ("exp_avg", "exp_avg_sq")}


def trainer_arrays(tr, kind: str) -> dict:
    """{"params": flat arrays, <buffer name>: flat arrays} of a trainer's
    state in the JAX package's layouts; an ArcFace trainer's classifier and
    its momentum whole (gathered over the mesh's model row: a collective)."""
    from frp_tpu_torch.models.params import flatten_params, to_numpy_params

    def tree(fn):
        def walk(node):
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items() if not k.startswith("_")}
            if isinstance(node, list):
                return [walk(v) for v in node]
            return None if node is None else fn(node)
        return walk(tr.state["params"])

    def flat(t: dict) -> dict:
        if kind == "arcface":
            t = {**t, "classifier": torch.from_numpy(tr.gather_classifier(t["classifier"]))}
        return flatten_params(to_numpy_params(t))

    out = {"params": flat(tree(lambda p: p))}
    for key in BUFFERS[kind]:
        out[key] = flat(tree(lambda p: tr.optimizer.state[p][key]))
    return out


@contextlib.contextmanager
def counted_collectives():
    """Count the ``all_reduce`` and ``broadcast`` calls made inside (the
    port's only collectives), by the size of their group: yields {ranks in
    the group: calls}. The port passes a group by keyword."""
    import torch.distributed as dist

    calls: dict = {}
    real = {name: getattr(dist, name) for name in ("all_reduce", "broadcast")}

    def counting(fn):
        def call(tensor, *args, **kwargs):
            n = dist.get_world_size(kwargs.get("group"))
            calls[n] = calls.get(n, 0) + 1
            return fn(tensor, *args, **kwargs)
        return call

    for name, fn in real.items():
        setattr(dist, name, counting(fn))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


@contextlib.contextmanager
def one_rank_groups():
    """Trainers built inside take the collective path over every axis of a
    process mesh, a group of one rank included, and average their
    gradients by the rule of that path: the port's step before it dropped
    the groups of one."""
    from frp_tpu_torch.parallel.collectives import average_gradients
    from frp_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
    from frp_tpu_torch.train.arcface import MeshSplit

    init = MeshSplit.__init__

    def old_average(self, params, own_columns=False):
        if self.data is None:
            return
        if own_columns or self.n_model == 1:
            average_gradients(params, self.data, self.n_data)
        else:
            average_gradients(params, None, self.n_data * self.n_model)

    def keep(self, mesh=None, what="training"):
        init(self, mesh, what)
        if mesh is not None and mesh.is_process_mesh:
            self.data, self.model = mesh.get_group(DATA_AXIS), mesh.get_group(MODEL_AXIS)
            self.average_gradients = types.MethodType(old_average, self)

    MeshSplit.__init__ = keep
    try:
        yield
    finally:
        MeshSplit.__init__ = init


def check_checkpoint(tr, path: str, fresh) -> None:
    """Save ``tr``'s state to ``path`` (on every rank: a collective), load
    it into ``fresh()``'s new trainer and assert that every tensor and the
    step came back as this rank holds them."""
    from frp_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint, state_tensors

    save_checkpoint(path, tr.state)
    new = fresh()
    assert load_checkpoint(path, like=new.state) is new.state, "the checkpoint was refused"
    assert new.state["step"] == tr.state["step"]
    want, got = state_tensors(tr.state), state_tensors(new.state)
    assert got.keys() == want.keys()
    for k, t in want.items():
        assert torch.equal(got[k], t), f"{k} was not restored"


def train_case(rank: int, world: int, store: str, spec: dict):
    """One rank of a process mesh (spec: "device", "backend" (None: nccl on
    a card, gloo on the CPU), "n_model", "tf32" (False turns it off),
    "cases" {name: {"kind", "kwargs", "batch", "steps" (1), "n_model" (the
    spec's), "mesh" (True; False builds the trainer without one, this
    process alone), "checkpoint" (None; a path: every rank saves the state
    there after the steps and restores it into a new trainer, which must
    then hold this rank's state exactly), "groups_of_one" (False; True
    builds the trainer under ``one_rank_groups``)}}): each case's trainer
    takes its steps on the global batch over the mesh of its model axis.
    Rank 0 returns {name: {"metrics" (of every step), "ms" (the synchronized
    host ms of each step), "shapes", "collectives" (the steps' calls by
    group size, ``counted_collectives``), and trainer_arrays' arrays}, "seconds":
    {"entered" (the clock's time at entry), "start" (s to the group's
    bring-up), name: s}}; the other ranks their "seconds" only. One
    intra-op thread a rank."""
    entered = time.time()
    t0 = time.perf_counter()
    torch.set_num_threads(1)
    from frp_tpu_torch.parallel import distributed_initialize, make_global_mesh

    dev = torch.device(spec["device"])
    if not spec.get("tf32", True):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    distributed_initialize(f"file://{store}", world, rank, backend=spec.get("backend"),
                           device=dev)
    try:
        meshes: dict = {}
        out = {"seconds": {"entered": entered, "start": time.perf_counter() - t0}}
        for name, case in spec["cases"].items():
            t0 = time.perf_counter()
            n_model = case.get("n_model", spec.get("n_model", 1))
            if n_model not in meshes:
                meshes[n_model] = make_global_mesh(n_model)
            mesh = meshes[n_model]
            kind = case["kind"]
            with one_rank_groups() if case.get("groups_of_one") else contextlib.nullcontext():
                if case.get("mesh", True):
                    tr = make_trainer(kind, mesh, **case["kwargs"])
                else:  # the same trainer in this process alone, for comparison
                    tr = make_trainer(kind, None, device=dev, **case["kwargs"])
            metrics, ms = [], []
            with counted_collectives() as collectives:
                for _ in range(case.get("steps", 1)):
                    t = time.perf_counter()
                    metrics.append(tr.train_step(*case["batch"]))
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t) * 1e3)
            if case.get("checkpoint"):
                check_checkpoint(tr, case["checkpoint"],
                                 lambda: make_trainer(kind, mesh, **case["kwargs"]))
            arrays = trainer_arrays(tr, kind)
            shapes = {}
            if kind == "arcface":
                w = tr.state["params"]["classifier"]
                shapes = {"classifier": tuple(w.shape),
                          "momentum": tuple(tr.optimizer.state[w]["momentum_buffer"].shape),
                          "mesh": mesh.shape}
            out[name] = dict(metrics=metrics, ms=ms, shapes=shapes, collectives=collectives,
                             **arrays)
            out["seconds"][name] = time.perf_counter() - t0
        return out if rank == 0 else {"seconds": out["seconds"]}
    finally:
        torch.distributed.destroy_process_group()
