"""A dry run of the port's mesh on the CPU (the twin of the JAX package's
``__graft_entry__.dryrun_multichip``).

    python -m frp_tpu_torch.testing.dryrun_multichip N

Starts N gloo processes on the CPU (one torch thread each, joined through a
file store) over a process mesh of N positions (data x model: 2 model
positions when N is even and at least 4) and runs, in each:

* one dp x tp ArcFace step (f32, 16 classes, a batch of 2 rows a data
  position): finite, each rank's classifier columns of the expected shape,
  and rank 0 holds the loss and the gathered classifier against a
  one-process trainer's step on the same batch;
* sharded FedAvg of one client a data position against the host combine.

Then, in this process, the engine over a mesh of the CPU repeated once a
data position against the engine without one, on rendered scenes whose
faces are found: ``process_frames``, and the serving path (an active-rows
I420 batch, three ``submit`` then ``fetch_many``). Last, two processes
brought up through ``FRP_COORDINATOR`` / ``FRP_NUM_PROCESSES`` /
``FRP_PROCESS_ID`` average one client each into the JAX leg's 1.5.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import torch

from frp_tpu_torch.testing.ranks import spawn_ranks

NUM_CLASSES = 16


def model_axis(n: int) -> int:
    return 2 if n % 2 == 0 and n >= 4 else 1


def _batch(n_data: int):
    rng = np.random.default_rng(0)
    images = rng.normal(0, 0.5, size=(2 * n_data, 112, 112, 3)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, size=(2 * n_data,)).astype(np.int32)
    return images, labels


def _rank(rank: int, n: int, store: str) -> None:
    """One process of the mesh: the ArcFace step and the sharded FedAvg."""
    torch.set_num_threads(1)
    from frp_tpu_torch.ops.fedavg import fedavg_combine
    from frp_tpu_torch.parallel import (
        DATA_AXIS,
        distributed_initialize,
        fedavg_sharded,
        make_global_mesh,
    )
    from frp_tpu_torch.train.arcface import ArcFaceTrainer

    distributed_initialize(f"file://{store}", n, rank, device="cpu")
    try:
        mesh = make_global_mesh(n_model=model_axis(n))
        n_data = mesh.shape[DATA_AXIS]
        i, _ = mesh.position
        images, labels = _batch(n_data)
        trainer = ArcFaceTrainer(num_classes=NUM_CLASSES, mesh=mesh, learning_rate=0.05,
                                 compute_dtype="float32")
        m = trainer.train_step(images, labels)
        shard = tuple(trainer.state["params"]["classifier"].shape)
        if not np.isfinite(m["loss"]) or shard != (128, NUM_CLASSES // model_axis(n)):
            raise AssertionError(f"rank {rank}: loss {m['loss']}, classifier shard {shard}")
        gathered = trainer.gather_classifier()
        if rank == 0:
            one = ArcFaceTrainer(num_classes=NUM_CLASSES, learning_rate=0.05,
                                 compute_dtype="float32", device="cpu")
            want = one.train_step(images, labels)
            np.testing.assert_allclose(m["loss"], want["loss"], rtol=1e-4)
            np.testing.assert_allclose(gathered, one.gather_classifier(), atol=1e-3)
            print(f"mesh: {mesh.shape} over {n} processes; train step ok: loss "
                  f"{m['loss']:.4f} (one process {want['loss']:.4f}), classifier shard "
                  f"{shard}", flush=True)

        rng = np.random.default_rng(1)
        updates = {f"c{k}": {"w": rng.normal(size=(8, 16)).astype(np.float32)}
                   for k in range(n_data)}
        stacked = {"w": np.stack([updates[f"c{k}"]["w"] for k in range(n_data)])}
        wvec = np.full((n_data,), 1.0 / n_data, np.float32)
        # each process passes its own data position's client
        got = fedavg_sharded(mesh, {"w": stacked["w"][i : i + 1]}, wvec[i : i + 1])["w"]
        host = fedavg_combine(updates, {c: 1.0 / n_data for c in updates})["w"]
        np.testing.assert_allclose(got.numpy(), host, rtol=1e-5, atol=1e-6)
        if rank == 0:
            print("sharded FedAvg ok (matches host combine)", flush=True)
    finally:
        torch.distributed.destroy_process_group()


def _engine_leg(n_data: int) -> None:
    from frp_tpu_torch.config import load_config
    from frp_tpu_torch.engine.batching import active_rows_for, build_batch_i420
    from frp_tpu_torch.engine.pipeline import RecognitionEngine
    from frp_tpu_torch.parallel import make_mesh
    from frp_tpu_torch.testing.synthetic import make_scene

    cfg = load_config(det_size=128, max_faces_per_frame=4, pre_nms_topk=64)
    mesh = make_mesh(n_data=n_data, devices=["cpu"] * n_data)
    eng = RecognitionEngine(cfg, mesh=mesh)
    single = RecognitionEngine(cfg, device="cpu")
    # rendered scenes, not noise: the shipped detector finds nothing in
    # noise, and a leg that finds no face would pass every equality
    frames = np.stack([make_scene(128, np.random.default_rng(100 + i), max_faces=1)[0]
                       for i in range(n_data)])
    out = eng.process_frames(frames)
    if out["boxes"].shape != (n_data, 4, 4) or int(out["count"].sum()) == 0:
        raise AssertionError(f"sharded inference: boxes {out['boxes'].shape}, counts "
                             f"{out['count'].tolist()}")
    print(f"sharded inference ok: counts={out['count'].tolist()}", flush=True)

    cams = {i: np.ascontiguousarray(f[..., ::-1]) for i, f in enumerate(frames)}
    rows = active_rows_for([f.shape[:2] for f in cams.values()], cfg.det_size)
    b_i420, _ = build_batch_i420(cams, cfg.det_size, active_rows=rows)
    outs = eng.fetch_many([eng.submit(b_i420, fmt="yuv420") for _ in range(3)])
    ref = eng.process_frames(b_i420, fmt="yuv420")
    want = single.process_frames(b_i420, fmt="yuv420")
    for o in (*outs, ref):
        np.testing.assert_array_equal(o["valid"], want["valid"])
        np.testing.assert_array_equal(o["count"], want["count"])
        np.testing.assert_allclose(o["boxes"], want["boxes"], atol=1e-3)
    if int(want["count"].sum()) == 0:
        raise AssertionError("the serving leg found no face")
    print(f"sharded serving path ok: submit + fetch_many == process_frames == one-device "
          f"engine on I420, faces={int(want['count'].sum())}", flush=True)


COORDINATOR_LEG = textwrap.dedent("""
    import numpy as np, torch
    torch.set_num_threads(1)
    from frp_tpu_torch.parallel import distributed_initialize, fedavg_sharded, make_global_mesh
    info = distributed_initialize(device="cpu")
    assert info["enabled"] and info["num_processes"] == 2, info
    mesh = make_global_mesh()
    pid = info["process_id"]
    local = np.full((1, 4), float(pid + 1), np.float32)
    out = fedavg_sharded(mesh, {"w": local}, np.array([0.5], np.float32))["w"].numpy()
    np.testing.assert_allclose(out, 1.5)
    print(f"COORDINATOR-OK proc={pid}", flush=True)
    torch.distributed.destroy_process_group()
""")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def coordinator_leg(repo: str, torchrun: bool = False, timeout: float = 300) -> list[str]:
    """Two processes brought up through FRP_COORDINATOR, FRP_NUM_PROCESSES
    and FRP_PROCESS_ID (or, with ``torchrun``, MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE and RANK) average one client each: (1 + 2) / 2 on both.
    Returns their outputs."""
    port = free_port()
    procs = []
    for pid in range(2):
        env = {k: v for k, v in os.environ.items()
               if k not in ("FRP_COORDINATOR", "FRP_NUM_PROCESSES", "FRP_PROCESS_ID",
                            "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
        if torchrun:
            env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2",
                       RANK=str(pid))
        else:
            env.update(FRP_COORDINATOR=f"localhost:{port}", FRP_NUM_PROCESSES="2",
                       FRP_PROCESS_ID=str(pid))
        env["PYTHONPATH"] = repo
        procs.append(subprocess.Popen([sys.executable, "-c", COORDINATOR_LEG], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"COORDINATOR-OK proc={pid}" not in out:
            raise RuntimeError(f"coordinator leg process {pid} failed:\n{out[-2000:]}")
    return outs


def dryrun_multichip(n: int) -> None:
    spawn_ranks(n, _rank)
    _engine_leg(n // model_axis(n))
    coordinator_leg(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    print("2-process FRP_COORDINATOR leg ok: the cross-process mean is 1.5", flush=True)
    print("dryrun_multichip passed", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(2)
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
