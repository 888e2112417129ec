"""PyTorch port, the program's spans on the CPU: the engine's calls and
stages as ranges under ``torch.profiler`` and nothing entered without one,
a span that keeps the GIL, ``StageTimers.track`` as a span, and the
operator's ``DeviceTracer`` recording a span opened on another thread."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from frp_tpu_torch.config import load_config
from frp_tpu_torch.engine.batching import DeltaEncoder
from frp_tpu_torch.engine.pipeline import RecognitionEngine
from frp_tpu_torch.utils import profiling
from frp_tpu_torch.utils.profiling import DeviceTracer, StageTimers, span

DET = 128
BLOCK = 128
KW = dict(det_size=DET, max_faces_per_frame=4, pre_nms_topk=64, compute_dtype="float32")
STAGES = ["frp.delta_ingest", "frp.detect", "frp.crop", "frp.embed", "frp.match_pack"]


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs its files in parallel worker processes: two intra-op
    threads a test keep those from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine():
    return RecognitionEngine(load_config(**KW), device="cpu")


def _payloads(n: int) -> list:
    """A keyframe of 2 I420 frames, then n - 1 deltas that each rewrite one
    block a frame (hinted, so the encoder diffs only that block)."""
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (2, DET * 3 // 2, DET), dtype=np.uint8)
    enc = DeltaEncoder(block_bytes=BLOCK)
    out = [enc.encode(frames.copy())]
    for t in range(1, n):
        frames.reshape(2, -1)[:, t * BLOCK:(t + 1) * BLOCK] = t
        out.append(enc.encode(frames.copy(), hints=[[(t, t + 1)]] * 2))
    assert [p[0] for p in out] == ["raw"] + ["delta"] * (n - 1)
    return out


def _profiled(fn, **kw):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], **kw) as prof:
        fn()
    return [e for e in prof.events() if e.name.startswith("frp.")]


def _children(ev) -> list:
    return [c.name for c in ev.cpu_children if c.name.startswith("frp.")]


def test_engine_calls_hold_their_stages_in_order(engine):
    raw, delta = _payloads(2)
    engine.fetch(engine.submit_encoded(raw))
    events = _profiled(lambda: engine.fetch_many([engine.submit_encoded(delta)]))
    top = [e for e in events if e.cpu_parent is None or not e.cpu_parent.name.startswith("frp.")]
    assert [e.name for e in top] == ["frp.submit_encoded", "frp.fetch_many"]
    submit, fetch = top
    assert _children(submit) == STAGES
    assert _children(fetch) == ["frp.to_host"]
    # a keyframe and a plain submit: ingest in place of delta_ingest
    frames = np.zeros((2, DET, DET, 3), np.uint8)
    events = _profiled(lambda: (engine.fetch(engine.submit_encoded(raw)),
                                engine.fetch(engine.submit(frames, packed=False))))
    calls = [e for e in events if e.name in ("frp.submit_encoded", "frp.submit")]
    assert _children(calls[0]) == ["frp.ingest"] + STAGES[1:]
    assert _children(calls[1]) == STAGES[1:4] + ["frp.match"]
    events = _profiled(lambda: engine.process_frames(frames))
    call = next(e for e in events if e.name == "frp.process_frames")
    assert _children(call) == STAGES[1:4] + ["frp.match", "frp.to_host"]


def test_put_payload_is_a_span(engine):
    raw, delta = _payloads(2)
    engine.fetch(engine.submit_encoded(raw))
    events = _profiled(lambda: engine.fetch(engine.submit_encoded(engine.put_payload(delta))))
    assert [e.name for e in events if e.cpu_parent is None] == [
        "frp.put_payload", "frp.submit_encoded", "frp.fetch_many"]


def test_no_range_is_entered_without_a_profiler(engine, monkeypatch):
    entered = []
    real = profiling._RANGE

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "_RANGE", counting)
    payloads = _payloads(3)
    engine.fetch(engine.submit_encoded(payloads[0]))
    engine.fetch_many([engine.submit_encoded(p) for p in payloads[1:]])
    timers = StageTimers()
    with timers.track("scan.read"):
        pass
    assert not torch.autograd.profiler._is_profiler_enabled
    assert entered == []
    # the same calls under a profiler enter every span
    _profiled(lambda: engine.fetch(engine.submit_encoded(payloads[0])))
    assert entered[0] == "frp.submit_encoded" and "frp.to_host" in entered


def test_span_is_one_shared_no_op_when_off():
    assert span("frp.a") is span("frp.b") is profiling._OFF
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(span("frp.a"), profiling._RANGE)


def test_span_keeps_the_gil():
    """A span under a profiler makes no operator call (which would release
    the GIL to a busy thread for a switch interval at each span)."""
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            pass

    th = threading.Thread(target=spin)
    th.start()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            t0 = time.perf_counter()
            for _ in range(100):
                with span("frp.a"):
                    pass
            per_call = (time.perf_counter() - t0) / 100
    finally:
        stop.set()
        th.join()
    # an operator call gives the GIL away for ~1.5 ms a span here; ~2 us without
    assert per_call < 2e-4, per_call


def test_stage_timers_track_emits_its_span():
    timers = StageTimers()

    def scan():
        with timers.track("scan.encode"):
            torch.ones(4).sum()

    events = _profiled(scan)
    assert [e.name for e in events] == ["frp.scan.encode"]
    assert timers.summary()["scan.encode"]["calls"] == 1


def test_device_tracer_records_a_span_of_another_thread(tmp_path):
    tracer = DeviceTracer(str(tmp_path))
    started = tracer.start("threads")
    assert started["success"], started

    def work():
        with span("frp.other_thread"):
            torch.ones(8).sum()

    th = threading.Thread(target=work)
    th.start()
    th.join()
    with span("frp.main_thread"):
        torch.ones(8).sum()
    stopped = tracer.stop()
    assert stopped["success"], stopped
    with open(os.path.join(stopped["trace_dir"], "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    tids = {e["name"]: e["tid"] for e in events if e.get("name", "").startswith("frp.")}
    assert set(tids) == {"frp.other_thread", "frp.main_thread"}
    assert tids["frp.other_thread"] != tids["frp.main_thread"]
