"""The readers of the program's spans and counter on synthetic profiles:
each stage's device ms a batch (the kernels and copies launched inside its
spans, each op's once), the host syncs made inside the engine's calls on
their thread, the embed stage's useful share of its slots, and nothing
read from a slice without the program's spans."""

import itertools
from types import SimpleNamespace

import pytest

from perfbench import common

STAGES = ("delta_ingest", "detect", "crop", "embed", "match_pack")
MAIN, OTHER = 4101, 4102  # the system threads of the main thread and of another
_ids = itertools.count(1)


class Ev:
    """A host event of ``torch.profiler``'s ``events()``: its kernels
    (name, us) and children."""

    def __init__(self, name, kernels=(), children=(), id=None, tid=MAIN):
        self.name = name
        self.id = next(_ids) if id is None else id
        self.device_resource_id = tid
        self.device_type = SimpleNamespace(name="CPU")
        self.kernels = [SimpleNamespace(name=n, duration=us) for n, us in kernels]
        self.cpu_children = list(children)
        self.cpu_parent = None
        for c in self.cpu_children:
            c.cpu_parent = self


def _flat(roots):
    out = []
    for r in roots:
        out.append(r)
        out.extend(_flat(r.cpu_children))
    return out


def _op(kernel_us, name="aten::conv2d", extra=()):
    return Ev(name, [("void kernel<bf16>", kernel_us)], children=extra)


def _launching(kernel_us, name="aten::add"):
    """An op whose launch holds another event with the op's id (module
    loading), and with it a second copy of the op's kernel, as
    ``torch.profiler`` gives."""
    op = _op(kernel_us, name)
    launch = Ev("cudaLaunchKernel", children=[
        Ev("Lazy Function Loading", [("void kernel<bf16>", kernel_us)], id=op.id)])
    launch.cpu_parent = op
    op.cpu_children.append(launch)
    return op


def _batch(scale=1.0):
    """One submit_encoded: each stage launches kernels inside ops, crop's
    kernel straight from the span."""
    return Ev("frp.submit_encoded", children=[
        Ev("frp.delta_ingest", [("Memcpy HtoD (Pinned -> Device)", 10 * scale)],
           children=[_op(100 * scale, "aten::index_put_")]),
        Ev("frp.detect", children=[_op(200 * scale), _launching(50 * scale)]),
        Ev("frp.crop", [("warp_crops_kernel", 30 * scale)]),
        Ev("frp.embed", children=[_op(1000 * scale, extra=[_op(500 * scale, "aten::mul")])]),
        Ev("frp.match_pack", children=[_op(40 * scale, "aten::mm"),
                                       Ev("cudaEventSynchronize"),
                                       # another thread's call, placed here by time
                                       Ev("cudaStreamSynchronize", tid=OTHER)]),
    ])


def _fetch(redo_embed_us=0.0):
    inner = [Ev("frp.to_host", children=[
        Ev("aten::copy_", [("Memcpy DtoH (Device -> Pageable)", 20)],
           children=[Ev("cudaMemcpyAsync"), Ev("cudaStreamSynchronize")])])]
    if redo_embed_us:
        inner.append(Ev("frp.redo", children=[Ev("frp.embed", children=[_op(redo_embed_us)])]))
    return Ev("frp.fetch_many", children=inner)


class Profile:
    def __init__(self, roots):
        self._events = _flat(roots)

    def events(self):
        return self._events


def _run(roots):
    return {"trace": SimpleNamespace(prof=Profile(roots))}


def _read(name, run):
    return common.metric_reader(name)(run)


def test_stage_ms_sum_each_stage_over_batches():
    run = _run([_batch(), _batch(2.0), _fetch(redo_embed_us=300.0),
                Ev("frp.put_payload", [("Memcpy HtoD (Pinned -> Device)", 999)])])
    want = {"delta_ingest": 110 * 3, "detect": 250 * 3, "crop": 30 * 3,
            "embed": 1500 * 3 + 300, "match_pack": 40 * 3}
    for stage in STAGES:
        assert _read(f"stage_ms.{stage}", run) == pytest.approx(want[stage] / 1e3 / 2), stage


def test_syncs_per_batch_counts_blocking_calls_nested_in_the_calls():
    # the transfer thread's sync has no parent among the engine's calls
    run = _run([_batch(), _batch(), _fetch(), Ev("cudaStreamSynchronize"),
                Ev("frp.put_payload", children=[Ev("cudaStreamSynchronize")])])
    # one cudaEventSynchronize in each submit, one cudaStreamSynchronize in the fetch
    assert _read("syncs_per_batch", run) == pytest.approx(3 / 2)
    run = _run([Ev("frp.submit_encoded", children=[Ev("cudaMemcpyAsync")]), _fetch(),
                Ev("cudaDeviceSynchronize")])
    assert _read("syncs_per_batch", run) == pytest.approx(1.0)


def test_busy_mfu_takes_a_batchs_device_time(monkeypatch):
    from perfbench import flops

    monkeypatch.setattr(flops, "per_frame_and_face", lambda cfg, wdir, n: (2e9, 5e8))
    run = _run([_batch(), _batch(2.0), _fetch(redo_embed_us=300.0),
                Ev("frp.put_payload", [("Memcpy HtoD (Pinned -> Device)", 999)])])
    run.update(spec={"config": {}}, weights_dir="", gallery_size=100, frames_per_batch=16,
               batches=[(1, 10.5, 192), (2, 11.0, 190)])
    work = 16 * 2e9 + 191 * 5e8
    per_batch_s = (1930 * 3 + 300) / 1e6 / 2
    assert _read("busy_mfu", run) == pytest.approx(100 * work / (per_batch_s * 989e12))


@pytest.mark.parametrize("name", [f"stage_ms.{s}" for s in STAGES]
                         + ["syncs_per_batch", "busy_mfu"])
def test_span_readers_find_nothing_without_the_programs_spans(name):
    # the parent program: host ops and kernels, no frp.* span
    run = _run([_op(100.0), Ev("cudaStreamSynchronize")])
    assert _read(name, run) is None
    assert _read(name, {"trace": None}) is None
    assert _read(name, {}) is None


def test_embed_slot_share():
    batches = [(1, 10.0, 1536), (2, 10.2, 1536), (3, 10.4, 1520)]
    run = {"batches": batches, "embed_stats": {"speculated": 3, "redone": 0, "whole": 0,
                                               "slots": 3 * 1664}}
    assert _read("embed_slot_share", run) == pytest.approx(100 * 4592 / 4992)
    # the parent program keeps no slot counter
    run["embed_stats"] = {"speculated": 3, "redone": 0, "whole": 0}
    assert _read("embed_slot_share", run) is None


def test_a_traced_run_on_the_cpu_reads_the_programs_spans():
    """The harness's own profile of the traced slice holds the program's
    spans and the window's slot count (on the CPU no kernel: 0 ms); four
    ticks a batch, 64 slots, so that the embed stage compacts."""
    from perfbench import run
    from perfbench.tests.test_pb_harness import tiny

    spec = tiny("r50.stream")
    spec["traffic"]["ticks_per_batch"] = 4
    result, rows, rec = run.execute(spec, 2**33 + 41, 1.0, True, device="cpu")
    assert result["correct"], rows
    got = result["metrics"]
    for stage in STAGES:
        assert got[f"stage_ms.{stage}"]["value"] == 0.0, stage
    assert got["syncs_per_batch"]["value"] == 0.0
    assert "busy_mfu" not in got  # no kernel on the CPU: nothing to read
    assert got["faces_per_s.wall"]["value"] == pytest.approx(rec["faces_per_s"])
    faces = sum(f for _, _, f in rec["batches"])
    assert faces and got["embed_slot_share"]["value"] == pytest.approx(
        100 * faces / rec["embed_stats"]["slots"])
