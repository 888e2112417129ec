"""The readings that the limits of ``perfbench/limits/<cell>.json`` are set
from, for one stream cell, in one process (the benchmark's own runs never
run this):

- the program's: a short run of the cell on each of ``--seeds`` seeds,
  through the same timed path and comparison as a benchmark run; the
  lower reading of a number is its largest over the seeds;
- the control's: on each of ``--control-seeds`` further seeds, the
  reference computed one precision below the configuration's bfloat16
  (fp8 e4m3 matmul inputs, ``perfbench/reference/precision.py``) put in the
  program's place, on as many batches of the same scene as a run compares,
  judged against the float32 reference; the upper reading of a number is
  its smallest over the seeds.

    python3 -m perfbench.control --workload r50.stream --seeds 12 --control-seeds 3

Prints a JSON line a seed and a last line with both readings of each
number and their ratio.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np

from perfbench import check, common, scene as scene_mod, stream


def control_numbers(spec: dict, seed: int, device) -> dict:
    """The control's numbers on the inputs a run of ``seed`` draws."""
    import torch

    from perfbench.reference.pipeline import Reference

    cfg, tr = spec["config"], spec["traffic"]
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    wdir = common.prepare_weights(cfg, seed, dev)
    scene = scene_mod.Scene(rng, tr["scene"])
    from frp_tpu_torch.engine.batching import active_rows_for

    rows = active_rows_for([f.shape[:2] for f in scene.cams], cfg["det_size"]) or cfg["det_size"]
    gal = stream.make_gallery(cfg, tr["gallery"], rng, scene, rows, wdir, dev)
    ticks, period = tr["ticks_per_batch"], scene.period
    n_batches = period // math.gcd(period, ticks)  # the distinct batches of a stream
    window = [(k, 0.0, 0) for k in range(1, n_batches + 1)]
    ks = stream.sample(window, ticks, period, tr["check_batches"], seed)
    refs, ctls = [], []
    with stream.float32_matmuls():
        ref = Reference(cfg, wdir, dev, "float32")
        ctl = Reference(cfg, wdir, dev, "fp8")
        for k in ks:
            yuv = stream.reference_i420(scene, k, ticks, cfg["det_size"], rows)
            ctls.append(check.as_results(ctl.faces(yuv, gal), cfg))
            refs.append(ref.faces(yuv, gal, check.landmarks(ctls[-1])))
    return check.compare(ctls, refs, cfg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=4_100_000_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = common.load_cell(args.workload)
    # readings need the sampled batches' results, not a steady rate
    spec["traffic"]["warm_batches"] = spec["traffic"]["depth"]
    prog, ctl = [], []
    for i in range(args.seeds):
        seed = args.first_seed + i
        rec = stream.run(spec, seed, args.seconds, False, device=args.device)
        prog.append(rec["numbers"])
        print(json.dumps({"side": "program", "seed": seed, **rec["numbers"], **rec["e2e"]}),
              flush=True)
    for i in range(args.control_seeds):
        seed = args.first_seed + 1000 + i
        ctl.append(control_numbers(spec, seed, args.device))
        print(json.dumps({"side": "control", "seed": seed, **ctl[-1]}), flush=True)
    names = [k for k in (ctl or prog)[0]
             if k not in ("batches", "faces", "why", "matched", "decided")]
    summary = {}
    for n in names:
        lo = max(p[n] for p in prog) if prog else None
        up = min(c[n] for c in ctl) if ctl else None
        summary[n] = {"lower": lo, "upper": up,
                      "ratio": (up / lo) if (lo and up is not None) else None}
    if prog:
        summary["frame_off"] = {"lower": max(p["frame_off"] for p in prog)}
    print(json.dumps({"workload": args.workload, "readings": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
