"""What every cell's run shares: the cell's files found by name, the
weights handed to both sides, the clock since the process began, the
device's description, the check that no JAX module was loaded, and the
result line.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration, found
as ``perfbench/configs/<config>.json`` through ``configs``' ``file``, and
a traffic mix, ``perfbench/traffic/<traffic>.json``. Its limits on the
numbers that decide ``correct`` are ``perfbench/limits/<cell>.json``. Each
per-layer metric is read by ``perfbench/metrics/<metric>.py``, each
hand-written kernel's work is counted by ``perfbench/kernels/<kernel>.py``
and an embedder that ``perfbench/reference/nets.py`` lacks is brought by
``perfbench/reference/embedders/<name>.py``: a later change adds a cell, a
metric, a kernel or an embedder as a new file.
"""

from __future__ import annotations

import glob
import hashlib
import importlib.util
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "perfbench")
# top-level module names a run may not load: the reference package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "frp_tpu")


def process_age_s() -> float:
    """Seconds since this process was started (from /proc), so that set-up
    counts the interpreter's start and every import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


_T_IMPORT = time.perf_counter()


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic, limits and the benchmark's metric entries that it reports."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    here = os.path.join(root, "perfbench")

    def reports(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if reports(m)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if reports(m) and m["moves"] in e2e_names]
    return {
        "cell": cell,
        "config": load_json(os.path.join(root, cfg_entry["file"])),
        "traffic": load_json(os.path.join(here, "traffic", f"{cell['traffic']}.json")),
        "limits": load_json(os.path.join(here, "limits", f"{name}.json")),
        "end_to_end": e2e,
        "per_layer": layer,
        "run_seconds": bench["run_seconds"],
    }


def _load_file(path: str, prefix: str):
    mod_name = prefix + os.path.basename(path)[:-3].replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: str = ROOT):
    """``perfbench/metrics/<name>.py``'s ``read(run)``."""
    return _load_file(os.path.join(root, "perfbench", "metrics", f"{name}.py"),
                      "perfbench_metric_").read


def kernel_counts(root: str = ROOT) -> list:
    """Every ``perfbench/kernels/<kernel>.py``: a module with ``NAME``,
    ``PATTERN`` (a regular expression on the kernel's name in the trace) and
    ``work(shapes) -> (bytes, operations)``."""
    return [_load_file(p, "perfbench_kernel_")
            for p in sorted(glob.glob(os.path.join(root, "perfbench", "kernels", "*.py")))
            if not os.path.basename(p).startswith("_")]


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def scratch_dir(*parts: str) -> str:
    """A directory of this benchmark under ``TMPDIR``, at a fixed path."""
    base = os.environ.get("TMPDIR") or os.path.join(ROOT, "build")
    path = os.path.join(base, "perfbench", *parts)
    os.makedirs(path, exist_ok=True)
    return path


def prepare_weights(cfg: dict, seed: int, device, root: str = ROOT) -> str:
    """The directory of weight files both sides load: copies of the shipped
    files, each checked against the configuration's sha256, and the seeded
    ones written from ``seed`` (``perfbench/weights.py``)."""
    out = scratch_dir("weights", cfg["name"])
    for stale in glob.glob(os.path.join(out, "*")):
        os.remove(stale)
    for fname, digest in cfg["shipped"].items():
        src = os.path.join(root, "weights", fname)
        got = sha256(src)
        if got != digest:
            raise SystemExit(f"weights/{fname} has sha256 {got}, the configuration "
                             f"{cfg['name']} states {digest}")
        shutil.copyfile(src, os.path.join(out, fname))
    if cfg["seeded"]:
        from perfbench import weights

        for fname, spec in cfg["seeded"].items():
            weights.write_seeded(os.path.join(out, fname), spec, seed, device)
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    reference package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(count)))}


def power_limit() -> str:
    import subprocess

    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return res.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def log(msg: str) -> None:
    print(f"[perfbench +{process_age_s():7.2f}s] {msg}", file=sys.stderr, flush=True)
