"""The metric arithmetic on synthetic traces: the union of device
intervals, the idle share and its gaps labelled by host spans, the kernels'
roofline share with each kernel's peak, the card's busy time,
and the kernel files' counts against ``chip_smoke.py::bound`` at the kernel
table's shapes."""

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


SHAPES = {"B": 16, "K": 256, "M": 16, "S": 640, "C": 112}
THREE = [("detection_head_kernel(float const*, float*, int)", 0.0, 12.9 * US),
         ("warp_crops_kernel(unsigned char const*, float const*, float*, int)", 1e-3, 1e-3 + 28.1 * US),
         ("warp_crops_kernel(unsigned char const*, float const*, float*, int)", 2e-3, 2e-3 + 28.3 * US),
         ("greedy_nms_kernel(float const*, unsigned char*, int)", 3e-3, 3e-3 + 10.5 * US),
         ("void at::native::elementwise_kernel<128, 4>", 4e-3, 5e-3)]


def test_roofline_of_the_three_kernels_reads_as_before_kernels_had_peaks():
    # the value measured on the same trace before a counts file could set its peak
    run = {"trace": FakeTrace(THREE, 0.0, 6e-3), "shapes": SHAPES}
    assert _reader("kernels_roofline")(run) == 44.52846743724963


@pytest.mark.parametrize("peak_line,want", [
    ("PEAK_OPS_PER_S = 989e12", 50.0),
    ("", 100 * 989e9 / 67e12 / 2e-3),  # no peak: the float32 rate
    ("PEAK_OPS_PER_S = 900e12", None),  # not a data-sheet rate
])
def test_a_kernel_is_counted_at_its_own_peak(tmp_path, monkeypatch, peak_line, want):
    (tmp_path / "perfbench/kernels").mkdir(parents=True)
    (tmp_path / "perfbench/kernels/gemm.py").write_text(
        f"NAME = 'gemm'\nPATTERN = r'\\bgemm_bf16\\b'\n{peak_line}\n\n\n"
        "def work(shapes):\n    return 1.0, 989e9\n")
    counts = common.kernel_counts
    monkeypatch.setattr(common, "kernel_counts", lambda: counts(root=str(tmp_path)))
    run = {"trace": FakeTrace([("gemm_bf16", 0.0, 2e-3)], 0.0, 3e-3), "shapes": SHAPES}
    if want is None:
        with pytest.raises(SystemExit, match="gemm.py: PEAK_OPS_PER_S 9e"):
            _reader("kernels_roofline")(run)
    else:
        assert _reader("kernels_roofline")(run) == pytest.approx(want)


class KinetoEv:
    def __init__(self, device, start_us, end_us, annotation=False):
        self.device, self.lo, self.hi, self.annotation = device, start_us, end_us, annotation

    def device_type(self):
        return self.device

    def start_ns(self):
        return self.lo * 1000

    def end_ns(self):
        return self.hi * 1000

    def is_user_annotation(self):
        return self.annotation


def test_device_busy_s_takes_the_union_of_the_devices_events():
    events = [KinetoEv("cuda", 0, 100), KinetoEv("cuda", 50, 150), KinetoEv("cuda", 300, 310),
              KinetoEv("cpu", 0, 1000),  # a runtime call on the host
              KinetoEv("cuda", 0, 1000, annotation=True)]  # a range over the kernels
    assert trace.device_busy_s(events, "cuda") == pytest.approx(160 * US)
    assert trace.device_busy_s([], "cuda") == 0.0


def test_the_wall_rate_reader():
    assert _reader("faces_per_s.wall")({"batches": [(1, 1.0, 5)], "faces_per_s": 7.5}) == 7.5
    assert _reader("faces_per_s.wall")({"batches": [], "faces_per_s": 0.0}) is None


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
