"""The port's bench end to end on the CPU (no card needed). Port of
``tools/bench_selftest.py``.

Runs the real ``frp_tpu_torch.bench`` attempt (``--once --device cpu``):
engine build, scene and motion, the banded letterbox caches, the hinted
delta encode with stacked ticks, the pipelined windows with their resident
batch check, the budget's partial-result path and the FLOP accounting, at
tiny shapes, so that a break in the bench shows here before a card run.
faces/s is 0 at det 128 (1080p faces letterbox below the detector's trained
pixel range); the contract is exit code 0 and one JSON line with every
detail field. One tick a submission, as the reference's self-test;
``BENCH_TICKS=2`` in the environment runs the card's stacked shape and the
8-frame warmup before the latency phase (about twice as long).

Usage: python -m frp_tpu_torch.tools.bench_selftest   (~45 s on 2 threads)
"""

from __future__ import annotations

import os
import runpy
import sys

SELFTEST_ENV = dict(
    BENCH_DET_SIZE="128", BENCH_DEPTH="2", BENCH_GROUP="2", BENCH_WINDOW="4",
    BENCH_WINDOWS="2", BENCH_BUDGET_S="600",
)


def main() -> None:
    os.environ.update(SELFTEST_ENV)
    sys.argv = ["frp_tpu_torch.bench", "--once", "--device", "cpu"]
    runpy.run_module("frp_tpu_torch.bench", run_name="__main__", alter_sys=True)


if __name__ == "__main__":
    main()
