"""PyTorch port, the mesh (1 of 2): ``parallel/mesh.py`` and
``parallel/fedavg.py``, the FL service's mesh branch, the engine and the
server over a mesh, ``--mesh`` and the dry run, on the CPU against the JAX
package on its 8-device CPU mesh (tests/conftest.py). A single-process mesh
of the port repeats the CPU device once a position.

Tolerances, and why:

- ``fedavg_sharded``: f32 partials added in another order than XLA's psum:
  rtol 1e-6; integer leaves bit for bit (weights of 1/4, so the f32 sums are
  exact and truncate alike).
- The engine over a mesh against JAX's engine over its mesh:
  ``tests/test_torch_engine.py``'s bounds (valid, count, best_idx and
  is_match bit for bit; boxes and landmarks within 1e-2 px, scores and
  distances within 1e-4, fake_prob 1e-3, quality 1e-2) on every tick of a
  keyframe and a delta stream; against the port's engine without a mesh,
  the same bounds (every stage is frame-local, but the CPU's convolutions
  round differently at a batch of 1, 2 and 4: up to 1.8e-6 on a distance
  measured).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from frp_tpu.config import load_config as j_load_config
from frp_tpu.engine.batching import DeltaEncoder
from frp_tpu.engine.pipeline import RecognitionEngine as JEngine
from frp_tpu.parallel import fedavg as jpfedavg
from frp_tpu.parallel import mesh as jmesh
from frp_tpu.platform.federated import FederatedService as JFederated
from frp_tpu.train.synthetic import make_scene

from frp_tpu_torch.api.main import build_app, parse_args, serving_mesh
from frp_tpu_torch.config import load_config
from frp_tpu_torch.engine.batching import DeltaEncoder as TDeltaEncoder
from frp_tpu_torch.engine.batching import build_batch_i420
from frp_tpu_torch.engine.pipeline import RecognitionEngine
from frp_tpu_torch.ops.fedavg import fedavg_combine
from frp_tpu_torch.parallel import mesh as tmesh
from frp_tpu_torch.parallel.fedavg import fedavg_sharded, pad_clients
from frp_tpu_torch.platform.context import AppContext
from frp_tpu_torch.platform.federated import FederatedService as TFederated
from frp_tpu_torch.testing.dryrun_multichip import coordinator_leg
from tests.test_torch_native import reference_framepack  # noqa: F401  (fixture reuse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = 128
KW = dict(det_size=DET, max_faces_per_frame=4, pre_nms_topk=64,
          det_conf_threshold=0.3, compute_dtype="float32")


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs its files in parallel worker processes: two intra-op
    threads a test keep those from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cpus(n: int) -> list:
    return [torch.device("cpu", k) for k in range(n)]


# --- meshes -------------------------------------------------------------------

@pytest.mark.parametrize("n_data,n_model", [(None, 1), (4, 2), (2, 4), (3, 1), (None, 2)])
def test_make_mesh_layout_equals_jax(n_data, n_model):
    import jax

    want = jmesh.make_mesh(n_data=n_data, n_model=n_model)
    got = tmesh.make_mesh(n_data=n_data, n_model=n_model, devices=_cpus(len(jax.devices())))
    assert dict(got.shape) == dict(want.shape) and got.axis_names == want.axis_names
    assert got.devices.size == want.devices.size and not got.is_process_mesh
    assert [[d.index for d in row] for row in got.devices] == \
        [[d.id for d in row] for row in want.devices]


def test_make_mesh_devices():
    assert not torch.cuda.is_available()  # this suite runs on a CPU host
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()  # every local card by default: there is none
    m = tmesh.make_mesh(n_data=2, devices=["cpu", "cpu"])  # a device may repeat
    assert m.devices.tolist() == [[torch.device("cpu")], [torch.device("cpu")]]
    assert m.device == torch.device("cpu")
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        tmesh.make_mesh(n_data=2, n_model=2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="no process groups"):
        m.get_group(tmesh.DATA_AXIS)
    assert [s for s in tmesh.data_rows(6, m)] == [slice(0, 3), slice(3, 6)]
    with pytest.raises(ValueError, match="3 rows does not divide the mesh's data axis of 2"):
        tmesh.data_rows(3, m)


def test_global_mesh_guards_equal_jax():
    """JAX's two guards, with their messages: the model axis must divide the
    positions of a host, and every host holds as many."""
    import jax

    n_local = len(jax.local_devices())
    with pytest.raises(ValueError, match="must divide local device count") as jerr:
        jmesh.make_global_mesh(n_model=n_local * 2)
    with pytest.raises(ValueError, match="must divide local device count") as terr:
        tmesh.global_grid(["a"] * n_local, n_local * 2)
    assert str(terr.value).split(" (")[0] == str(jerr.value).split(" (")[0]
    with pytest.raises(ValueError, match="must divide local device count 4"):
        tmesh.global_grid(["a"] * 4 + ["b"] * 4, 3)
    with pytest.raises(ValueError, match="heterogeneous device counts per process"):
        tmesh.global_grid(["a", "a", "a", "b"], 1)
    with pytest.raises(ValueError, match="several hosts"):
        tmesh.global_grid(["a", "b", "a", "b"], 2)
    np.testing.assert_array_equal(tmesh.global_grid(["a"] * 4 + ["b"] * 4, 2),
                                  np.arange(8).reshape(4, 2))
    with pytest.raises(RuntimeError, match="distributed_initialize"):
        tmesh.make_global_mesh()


def test_distributed_initialize_alone_is_a_noop(monkeypatch):
    names = ("FRP_COORDINATOR", "FRP_NUM_PROCESSES", "FRP_PROCESS_ID", "MASTER_ADDR",
             "MASTER_PORT", "WORLD_SIZE", "RANK", "JAX_COORDINATOR_ADDRESS")
    for k in names:
        monkeypatch.delenv(k, raising=False)
    want = jmesh.distributed_initialize()
    got = tmesh.distributed_initialize()
    assert got == want == {"enabled": False, "process_id": 0, "num_processes": 1,
                           "local_devices": None, "global_devices": None}
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("FRP_COORDINATOR", "localhost:1")
    with pytest.raises(ValueError, match="FRP_NUM_PROCESSES"):
        tmesh.distributed_initialize(device="cpu")
    assert not torch.distributed.is_initialized()


def test_process_card_is_the_local_rank(monkeypatch):
    """One process a card on hosts of 4 cards: torchrun's LOCAL_RANK names
    the card; an FRP_COORDINATOR launch, which sets none, takes the process
    id modulo the host's card count (ranks are process-major); a named
    device wins; without a card the default raises."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    got = [tmesh._process_device(None, pid) for pid in range(8)]
    assert got == [torch.device("cuda", k % 4) for k in range(8)]
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert tmesh._process_device(None, 6) == torch.device("cuda", 1)
    assert tmesh._process_device("cpu", 6) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh._process_device(None, 0)


def test_two_processes_by_torchrun_names_average_to_one_and_a_half():
    """JAX's 2-process leg (tests/test_multihost.py) through torchrun's
    variables; the dry run below takes FRP_COORDINATOR's."""
    outs = coordinator_leg(REPO, torchrun=True, timeout=120)
    assert all("COORDINATOR-OK" in o for o in outs)


# --- sharded FedAvg -----------------------------------------------------------

def test_fedavg_sharded_and_pad_clients_equal_jax():
    import jax

    n = len(jax.devices())
    rng = np.random.default_rng(2)
    jm, tm = jmesh.make_mesh(n_data=n), tmesh.make_mesh(n_data=n, devices=["cpu"] * n)
    cases = [
        # 5 float clients padded to 8, weights 1/5
        ({"w": rng.normal(size=(5, 4, 3)).astype(np.float32),
          "b": rng.normal(size=(5, 3)).astype(np.float32)}, np.full(5, 0.2, np.float32)),
        # int leaves: f32 weight math, truncated back (1/4 is exact)
        ({"i": rng.integers(-9, 9, size=(4, 6)).astype(np.int32)}, np.full(4, 0.25, np.float32)),
    ]
    for stacked, w in cases:
        js, jw = jpfedavg.pad_clients({k: jax.numpy.asarray(v) for k, v in stacked.items()},
                                      jax.numpy.asarray(w), n)
        ts, tw = pad_clients(stacked, w, n)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        for k in stacked:
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
            assert ts[k].dtype == torch.from_numpy(stacked[k]).dtype
        want = jax.device_get(jpfedavg.fedavg_sharded(jm, js, jw))
        got = fedavg_sharded(tm, ts, tw)
        host = fedavg_combine({c: {k: v[c] for k, v in stacked.items()} for c in range(len(w))},
                              {c: float(w[c]) for c in range(len(w))})
        for k in stacked:
            assert got[k].dtype == ts[k].dtype
            if stacked[k].dtype == np.int32:
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
                assert got[k].abs().sum() > 0  # the weights did not truncate to zero
            else:
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)
                np.testing.assert_allclose(got[k].numpy(), host[k], rtol=1e-5, atol=1e-7)
    assert pad_clients(cases[0][0], cases[0][1], 5)[0] is cases[0][0]  # nothing to pad
    with pytest.raises(ValueError, match="client stack of 5 rows"):
        fedavg_sharded(tm, cases[0][0], cases[0][1])


def test_federated_service_mesh_psum_equals_jax(tmp_path):
    rng = np.random.default_rng(4)
    updates = {c: {"w": rng.normal(size=(6, 5)), "b": rng.normal(size=5)} for c in "xyz"}
    jm = jmesh.make_mesh(n_data=8)
    svcs = [JFederated(weights_dir=str(tmp_path / "j"), mesh=jm),
            TFederated(weights_dir=str(tmp_path / "t"),
                       mesh=tmesh.make_mesh(n_data=8, devices=["cpu"] * 8))]
    res = []
    for svc in svcs:
        for c, u in updates.items():
            svc.upload_weights(c, {k: v.tolist() for k, v in u.items()})
        res.append(svc.aggregate(client_ids=list("xyz"), proportional=False))
    j, t = res
    assert t["backend"] == j["backend"] == "mesh_psum[8]"
    assert {k: t[k] for k in ("clients", "weights", "layer_count", "version")} == \
        {k: j[k] for k in ("clients", "weights", "layer_count", "version")}
    jw, tw = svcs[0].get_weights(j["global_model"]), svcs[1].get_weights(t["global_model"])
    mean = {k: np.mean([updates[c][k] for c in "xyz"], axis=0) for k in ("w", "b")}
    for k in mean:
        assert tw[k].dtype == np.float64
        np.testing.assert_allclose(tw[k], jw[k], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tw[k], mean[k], rtol=1e-5, atol=1e-6)  # the f32 combine


# --- the engine over a mesh -------------------------------------------------

def _stream(n=3, seeds=(3, 8, 5, 9)):
    """I420 batches of 4 rendered portrait scenes (one face each), a patch
    moving between ticks."""
    scenes = [make_scene(DET, np.random.default_rng(s), max_faces=1, portrait=True)[0]
              for s in seeds]
    seq = []
    for t in range(n):
        frames = {}
        for i, img in enumerate(scenes):
            img = img.copy()
            img[110:122, 8 + 12 * t : 20 + 12 * t] = (200, 40 * i, 90)
            frames[i] = img[..., ::-1].copy()
        seq.append(build_batch_i420(frames, DET)[0])
    return np.stack(scenes), seq


@pytest.fixture(scope="module")
def meshed():
    """JAX's engine over make_mesh(n_data=n) and the port's over n CPU
    positions, n = 2 and 4, and the port's engine without a mesh; one
    gallery in all (the faces at their own norms, and decoys)."""
    scenes, seq = _stream()
    one = RecognitionEngine(load_config(**KW), device="cpu")
    engines = {n: (JEngine(j_load_config(**KW), mesh=jmesh.make_mesh(n_data=n)),
                   RecognitionEngine(load_config(**KW), mesh=tmesh.make_mesh(
                       n_data=n, devices=["cpu"] * n)))
               for n in (2, 4)}
    first = one.process_frames(seq[0], fmt="yuv420")
    assert first["valid"].sum() == 4, "the shipped detector missed a face"
    # each face at its own norm, none at its own (a distance at 0 is the
    # square root of a cancellation, 1e-4 off between any two programs)
    faces = first["embeddings"][first["valid"]] * np.linspace(0.95, 0.8, 4, dtype=np.float32)[:, None]
    decoys = np.random.default_rng(0).normal(size=(3, 128)).astype(np.float32)
    for eng in (one, *(e for pair in engines.values() for e in pair)):
        for i, emb in enumerate([*faces, *decoys]):
            eng.gallery.add(f"id{i}", emb)
    return scenes, seq, one, engines


def _assert_like_jax(got: dict, want: dict) -> None:
    for key in ("valid", "count", "best_idx", "is_match"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    v = want["valid"]
    for key, atol in (("boxes", 1e-2), ("landmarks", 1e-2), ("scores", 1e-4),
                      ("fake_prob", 1e-3), ("quality", 1e-2), ("blur_score", 1e-2),
                      ("best_distance", 1e-4)):
        np.testing.assert_allclose(got[key][v], want[key][v], rtol=0, atol=atol, err_msg=key)


@pytest.mark.usefixtures("reference_framepack")
@pytest.mark.parametrize("n", [2, 4])
def test_engine_over_a_mesh_equals_jax_on_a_delta_stream(meshed, n):
    _, seq, one, engines = meshed
    jeng, teng = engines[n]
    assert teng.mesh is not None and len(teng._replicas) == n
    ej, et, eo = DeltaEncoder(block_bytes=128), TDeltaEncoder(block_bytes=128), \
        TDeltaEncoder(block_bytes=128)
    kinds = []
    for batch in seq:
        pj, pt, po = ej.encode(batch), et.encode(batch), eo.encode(batch)
        kinds.append(pt[0])
        want = jeng.fetch(jeng.submit_encoded(pj))
        got = teng.fetch(teng.submit_encoded(pt))
        _assert_like_jax(got, want)
        assert got["count"].sum() == 4
        _assert_like_jax(got, one.fetch(one.submit_encoded(po)))
        # each position holds its rows of the resident batch
        np.testing.assert_array_equal(teng._delta_prev.numpy(), batch)
        assert [tuple(r.shape) for r in teng._resident] == [(4 // n, *batch.shape[1:])] * n
    assert kinds == ["raw", "delta", "delta"]
    assert teng.delta_stats == {"keyframes": 1, "deltas": 2, "desyncs": 0}
    assert teng.precompile_delta_rungs() > 0
    np.testing.assert_array_equal(teng._delta_prev.numpy(), seq[-1])


def test_engine_over_a_mesh_full_tree_and_pipelined_calls(meshed):
    scenes, seq, one, engines = meshed
    jeng, teng = engines[2]
    want, got = jeng.process_frames(scenes), teng.process_frames(scenes)
    assert set(got) == set(want)
    _assert_like_jax(got, want)
    np.testing.assert_allclose(got["embeddings"][want["valid"]],
                               want["embeddings"][want["valid"]], atol=1e-4)
    # put_payload shards each array onto its position; fetch_many joins rows
    enc, ref_enc = TDeltaEncoder(block_bytes=128), TDeltaEncoder(block_bytes=128)
    ups = [teng.put_payload(enc.encode(b)) for b in seq]
    assert isinstance(ups[0][1], list) and len(ups[0][1]) == 2
    assert isinstance(ups[1][1], list) and [len(x) for x in ups[1][1]] == [2, 2]
    outs = teng.fetch_many([teng.submit_encoded(u) for u in ups])
    refs = [one.fetch(one.submit_encoded(ref_enc.encode(b))) for b in seq]
    for g, w in zip(outs, refs):
        _assert_like_jax(g, w)
    # the packed and the full results of one batch, fetched together
    both = teng.fetch_many([teng.submit(scenes), teng.submit(scenes, packed=False)])
    np.testing.assert_array_equal(both[0]["boxes"], both[1]["boxes"])
    assert both[1]["embeddings"].shape == (4, 4, 128)


def _assert_faces_equal(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["box"], w["box"], rtol=0, atol=1e-2)
        np.testing.assert_allclose(g["embedding"], w["embedding"], rtol=0, atol=1e-4)
        assert g["score"] == pytest.approx(w["score"], abs=1e-4)
        assert g["fake_prob"] == pytest.approx(w["fake_prob"], abs=1e-3)


def test_mesh_engine_takes_batches_the_data_axis_does_not_divide(meshed):
    """JAX's device_put refuses a P("data") batch whose rows the data axis
    does not divide: enrolment's B=1 and the CCTV sweep's B=3 (the
    reference's fault, left as it is). The port splits such a batch into
    nearly equal row shards, and its results equal the unsharded engine's;
    an engine still takes a device or a mesh, not both."""
    scenes, _, one, engines = meshed
    jeng, teng = engines[2]
    with pytest.raises(ValueError):
        jeng.encode_image(scenes[0])
    with pytest.raises(ValueError):
        jeng.process_frames(scenes[:3])
    _assert_faces_equal(teng.encode_image(scenes[0]), one.encode_image(scenes[0]))
    _assert_like_jax(teng.process_frames(scenes[:3]), one.process_frames(scenes[:3]))
    got = teng.fetch(teng.submit(scenes[:3]))
    _assert_like_jax(got, one.fetch(one.submit(scenes[:3])))
    assert got["count"].sum() == 3
    with pytest.raises(ValueError, match="not both"):
        RecognitionEngine(load_config(**KW), device="cpu", mesh=teng.mesh)


def test_serving_rows_split_nearly_equal():
    m4 = tmesh.make_mesh(n_data=4, devices=["cpu"] * 4)
    assert tmesh.serving_rows(5, m4) == [slice(0, 2), slice(2, 3), slice(3, 4), slice(4, 5)]
    assert tmesh.serving_rows(3, m4) == [slice(0, 1), slice(1, 2), slice(2, 3)]
    assert tmesh.serving_rows(8, m4) == tmesh.data_rows(8, m4)
    assert tmesh.serving_rows(0, m4) == [slice(0, 0)]
    with pytest.raises(ValueError):  # the trainers' and FedAvg's split keeps JAX's rule
        tmesh.data_rows(5, m4)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("b", [1, 3, 5])
def test_mesh_engine_on_any_batch_equals_the_unsharded_engine(meshed, n, b):
    """B = 1, 3, 5 over 2 and 4 positions (5 = the four scenes and the first
    again): process_frames, encode_image, submit / fetch and a delta stream
    through submit_encoded, whose resident batch keeps the split, and
    precompile_delta_rungs, against the engine without a mesh."""
    scenes, seq, one, engines = meshed
    teng = engines[n][1]

    def rows(x):
        return np.concatenate([x, x])[:b]

    frames = rows(scenes)
    got, want = teng.process_frames(frames), one.process_frames(frames)
    _assert_like_jax(got, want)
    np.testing.assert_allclose(got["embeddings"][want["valid"]],
                               want["embeddings"][want["valid"]], rtol=0, atol=1e-4)
    _assert_faces_equal(teng.encode_image(frames[-1]), one.encode_image(frames[-1]))
    _assert_like_jax(teng.fetch(teng.submit(frames)), one.fetch(one.submit(frames)))
    et, eo = TDeltaEncoder(block_bytes=128), TDeltaEncoder(block_bytes=128)
    for batch in seq:
        got = teng.fetch(teng.submit_encoded(et.encode(rows(batch))))
        _assert_like_jax(got, one.fetch(one.submit_encoded(eo.encode(rows(batch)))))
        assert got["count"].sum() == b
        np.testing.assert_array_equal(teng._delta_prev.numpy(), rows(batch))
    split = tmesh.serving_rows(b, teng.mesh)
    assert [int(r.shape[0]) for r in teng._resident] == [s.stop - s.start for s in split]
    assert teng.precompile_delta_rungs() > 0
    np.testing.assert_array_equal(teng._delta_prev.numpy(), rows(seq[-1]))


def test_warmup_and_server_start_over_a_mesh(tmp_path):
    """The server's start over a 2-position mesh with 3 cameras: warmup(1),
    the dry scan of a B=3 batch and the delta rungs run, and it serves."""
    import asyncio

    from frp_tpu_torch.api import main as tmain

    mesh = tmesh.make_mesh(n_data=2, devices=["cpu"] * 2)
    cfg = load_config(data_dir=str(tmp_path / "data"), log_dir=str(tmp_path / "logs"),
                      det_size=DET, max_faces_per_frame=4, pre_nms_topk=64, frames_per_batch=3)
    ctx = AppContext(cfg=cfg, camera_configs=[
        {"id": i, "name": f"Cam {i}", "geo": (18.5 + i * 0.01, 73.8),
         "source": "synthetic:128x96"} for i in range(3)], mesh=mesh)
    ctx.engine.warmup(1)

    async def start():
        bound = asyncio.get_running_loop().create_future()
        task = asyncio.create_task(tmain.serve("127.0.0.1", 0, ctx=ctx, ready=bound.set_result))
        await asyncio.wait({task, bound}, timeout=300, return_when=asyncio.FIRST_COMPLETED)
        if task.done():
            task.result()  # the start raised: raise it here
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        return bound.result()

    assert asyncio.run(start())[1] > 0
    assert ctx.engine.delta_stats["keyframes"] >= 1 and len(ctx.engine._resident) == 2


def test_gallery_copies_follow_its_version(meshed):
    _, _, _, engines = meshed
    g = engines[4][1].gallery
    devs = ["cpu", torch.device("cpu", 1)]
    (a, b), names = g.device_views(devs)
    assert a[0] is g.device_arrays()[0] and b[0] is not a[0] and torch.equal(b[0], a[0])
    again, _ = g.device_views(devs)
    assert again[1][0] is b[0]  # kept while the gallery is unchanged
    g.add("late", np.ones(128, np.float32))
    try:
        (a2, b2), names2 = g.device_views(devs)
        assert b2[0] is not b[0] and names2[-1] == "late" and "late" not in names
        assert torch.equal(b2[0], a2[0])
    finally:
        g.remove("late")


def test_meshed_serving_scan(tmp_path):
    """The twin of tests/test_integration.py::test_meshed_serving_scan: the
    port's AppContext with a mesh of 8 positions runs the 8-camera scan."""
    mesh = tmesh.make_mesh(n_data=8, devices=["cpu"] * 8)
    assert tmesh.distributed_initialize()["num_processes"] == 1  # a no-op alone
    cfg = load_config(data_dir=str(tmp_path / "data"), log_dir=str(tmp_path / "logs"),
                      det_size=DET, max_faces_per_frame=4, pre_nms_topk=64, frames_per_batch=8)
    ctx = AppContext(cfg=cfg, camera_configs=[
        {"id": i, "name": f"Cam {i}", "geo": (18.5 + i * 0.01, 73.8),
         "source": "synthetic:128x96"} for i in range(8)], mesh=mesh)
    try:
        router, sio, ctx = build_app(ctx)
        out = ctx.run_scan(0.6, 1, 10)
        assert out["scanned"] == 8 and isinstance(out["detections"], list)
        assert ctx.engine.mesh is mesh and ctx.federated.mesh is mesh
        assert len(ctx.engine._resident) == 8
    finally:
        ctx.shutdown()


def test_mesh_option_parses_and_one_device_serves_without_a_mesh(monkeypatch):
    monkeypatch.delenv("FRP_MESH", raising=False)
    for k in ("FRP_COORDINATOR", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert parse_args([]).mesh == "off"
    monkeypatch.setenv("FRP_MESH", "auto")
    args = parse_args(["--device", "cpu"])
    assert args.mesh == "auto"
    assert parse_args(["--mesh", "off"]).mesh == "off"
    with pytest.raises(SystemExit):
        parse_args(["--mesh", "all"])
    # one device (here the CPU): no mesh, as the JAX server with one device
    assert serving_mesh(args.mesh, args.device) is None
    assert serving_mesh("off", "cuda") is None
    assert serving_mesh("auto", "cuda") is None  # no card on this host: no mesh
    assert not torch.distributed.is_initialized()


def test_dryrun_multichip_runs_on_four_cpu_processes():
    res = subprocess.run([sys.executable, "-m", "frp_tpu_torch.testing.dryrun_multichip", "4"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    for line in ("mesh: {'data': 2, 'model': 2} over 4 processes", "sharded FedAvg ok",
                 "sharded inference ok", "sharded serving path ok",
                 "2-process FRP_COORDINATOR leg ok", "dryrun_multichip passed"):
        assert line in res.stdout, res.stdout[-3000:]
