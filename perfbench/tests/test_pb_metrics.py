"""The metric arithmetic on synthetic traces: the union of device
intervals, the idle share and its gaps labelled by host spans, the kernels'
roofline share, the whole step's share of the peak, and the kernel files'
counts against ``chip_smoke.py::bound`` at the kernel table's shapes."""

import pytest

from perfbench import common, trace
from perfbench.trace import Spans

US = 1e-6


class FakeTrace:
    def __init__(self, events, lo, hi):
        self.events, self.lo, self.hi = events, lo, hi

    def kernels(self):
        return [e for e in self.events if not e[0].startswith("Memcpy")]

    @property
    def seconds(self):
        return self.hi - self.lo


def test_union_idle_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 12.0)]
    assert trace.union_length(iv) == pytest.approx(6.0)
    assert trace.idle_share(iv, 0.0, 10.0) == pytest.approx(1 - 4.0 / 10.0)
    assert trace.gaps(iv, 0.0, 10.0) == [(2.0, 3.0), (4.0, 9.0)]
    spans = [("submit", 2.2, 2.8), ("encode", 4.0, 5.0), ("fetch", 5.0, 8.5)]
    assert trace.longest_gaps(iv, spans, 0.0, 10.0) == [["fetch+encode", 5.0], ["submit", 1.0]]
    assert trace.label((20.0, 21.0), spans) == "host idle"


def test_device_ops_by_name():
    ev = [("a", 0.0, 1.0), ("b", 1.0, 1.5), ("a", 2.0, 2.25)]
    assert trace.by_name(ev) == [["a", 1.25], ["b", 0.5]]


def _reader(name):
    return common.metric_reader(name)


def test_idle_share_and_kernels_per_batch_readers():
    dt = FakeTrace([("k1", 0.0, 0.25), ("Memcpy HtoD", 0.25, 0.5), ("k2", 0.75, 1.0)], 0.0, 1.0)
    spans = Spans()
    spans.add("submit", 0.1, 0.2)
    spans.add("submit", 0.6, 0.7)
    spans.add("submit", 1.5, 1.6)  # outside the slice
    run = {"trace": dt, "spans": spans}
    assert _reader("device_idle_share")(run) == pytest.approx(25.0)
    assert _reader("kernels_per_batch")(run) == pytest.approx(1.0)
    assert _reader("device_idle_share")({"trace": None}) is None


def test_roofline_reader_counts_each_launch_at_the_cell_shapes():
    shapes = {"B": 16, "K": 256, "M": 16, "S": 640, "C": 112}
    warp_s = (16 * 640 * 640 * 3 + 16 * 16 * 24 + 16 * 16 * 112 * 112 * 12) / 3.35e12
    ev = [("warp_crops_kernel(unsigned char const*, float const*, float*, int)", 0.0, 2 * warp_s),
          ("warp_crops_kernel(unsigned char const*, float const*, float*, int)", 1.0, 1.0 + 2 * warp_s),
          ("void at::native::elementwise_kernel<128, 4>", 2.0, 3.0)]
    run = {"trace": FakeTrace(ev, 0.0, 4.0), "shapes": shapes}
    assert _reader("kernels_roofline")(run) == pytest.approx(50.0)
    # a slice without a hand-written kernel has nothing to read: no 0
    run = {"trace": FakeTrace(ev[2:], 0.0, 4.0), "shapes": shapes}
    assert _reader("kernels_roofline")(run) is None


def test_step_mfu_reader(monkeypatch):
    from perfbench import flops

    monkeypatch.setattr(flops, "per_frame_and_face", lambda cfg, wdir, n: (2e9, 5e8))
    run = {"spec": {"config": {}}, "weights_dir": "", "gallery_size": 100,
           "frames_per_batch": 16, "window": (10.0, 12.0),
           "batches": [(1, 10.5, 192), (2, 11.0, 190), (3, 12.0, 0)]}
    work = 3 * 16 * 2e9 + (192 + 190) * 5e8
    assert _reader("step_mfu")(run) == pytest.approx(100 * work / (2.0 * 989e12))


def test_span_readers_take_the_window():
    spans = Spans()
    for i in range(10):
        spans.add("submit", i, i + 0.03)
        spans.add("encode", i + 0.1, i + 0.12)
        spans.add("encode", i + 0.2, i + 0.21)
    run = {"spans": spans, "window": (2.0, 6.0), "batches": [None] * 4}
    assert _reader("submit_ms.stream")(run) == pytest.approx(30.0)
    assert _reader("encode_ms.stream")(run) == pytest.approx(20.0 + 10.0)


@pytest.mark.parametrize("kernel,shapes,want_us", [
    ("warp_crops", {"B": 8, "M": 16, "S": 640, "C": 112}, 8.687),
    ("detection_head", {"B": 8, "K": 256, "M": 16}, 0.080),
    ("detection_head", {"B": 16, "K": 256, "M": 16}, 0.160),
    ("greedy_nms", {"B": 8, "K": 512}, 1.252),
    ("greedy_nms", {"B": 8, "K": 256}, 0.313),
])
def test_kernel_counts_meet_chip_smoke_bound(kernel, shapes, want_us):
    import chip_smoke

    k = next(k for k in common.kernel_counts() if k.NAME == kernel)
    ms, _ = chip_smoke.bound(*k.work(shapes))
    assert round(ms * 1e3, 3) == pytest.approx(want_us)
