"""One run of one benchmark cell of the PyTorch and CUDA port:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It needs as many CUDA cards as the cell asks
for and exits with another code than 0, printing no result, without them,
in a checkout without the program, or when a JAX module was loaded.

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer ones with ``--trace 1``), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number that decided
``correct`` with its limit. The checks are also the last lines on standard
error.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

if __package__ in (None, ""):  # run as a file: the checkout's root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import common  # noqa: E402


def layer_metrics(spec: dict, rec: dict) -> dict:
    """Each per-layer metric of the cell its reader finds something for."""
    out = {}
    for m in spec["per_layer"]:
        value = common.metric_reader(m["name"])(rec | {"spec": spec})
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(rec: dict) -> dict:
    from perfbench import trace as tr

    dt = rec["trace"]
    return {"device_ops": tr.by_name(dt.events),
            "idle_gaps": tr.longest_gaps([e[1:] for e in dt.events],
                                         rec["spans"].between(dt.lo, dt.hi), dt.lo, dt.hi)}


def execute(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
            fault=None) -> tuple[dict, list, dict]:
    """Drive one run of the cell past the look for a card: (the result
    line's object, the checks [[name, number, limit], ...], the run's
    record)."""
    from perfbench.check import judge

    loop = importlib.import_module(f"perfbench.{spec['traffic']['loop']}")
    rec = loop.run(spec, seed, seconds, trace, device=device, fault=fault)
    correct, rows = judge(rec["numbers"], spec["limits"])
    chips = spec["cell"]["chips"]
    device_rec = (common.device_info(chips) if device == "cuda"
                  else {"platform": "cpu", "kind": "cpu", "count": 1})
    device_rec["memory_peak_bytes"] = rec["memory_peak_bytes"]
    result = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"]}
    if trace:
        from perfbench import trace as tr

        dt = rec["trace"]
        result["metrics"] = layer_metrics(spec, rec)
        device_rec["busy_s"] = tr.union_length([e[1:] for e in dt.events])
        device_rec["window_s"] = dt.seconds
        result["device"] = device_rec
        result["breakdown"] = breakdown(rec)
    else:
        result["metrics"] = {m["name"]: {"value": rec["e2e"][m["name"]], "unit": m["unit"]}
                             for m in spec["end_to_end"]}
        result["device"] = device_rec
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    return result, rows, rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = common.load_cell(args.workload)
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    card = common.power_limit()
    common.log(f"{args.workload} seed {args.seed} on {card}")
    result, rows, rec = execute(spec, args.seed, args.seconds, bool(args.trace))
    found = common.forbidden_modules()
    if found:
        print(f"perfbench: modules of JAX or the reference package were loaded: {found}",
              file=sys.stderr)
        return 3
    print(f"perfbench: card {card}; compared {rec['numbers'].get('faces')} faces of batches "
          f"{rec['numbers'].get('batches')}", file=sys.stderr)
    for reason in rec["numbers"].get("why", []):
        print(f"answer off: {reason}", file=sys.stderr)
    for name, value, limit in rows:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
