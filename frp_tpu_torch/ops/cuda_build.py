"""Build and load the port's hand-written CUDA kernels (``frp_tpu_torch/csrc``).

Each kernel source is one ``.cu`` file with a plain C interface. ``nvcc``
compiles it for Hopper (``sm_90a``) into a shared library under
``build/frp_tpu_torch/`` at the repository root (listed in ``.gitignore``),
named by a hash of the sources and flags, so an edited kernel rebuilds and an
unchanged one is reused. ``ctypes`` loads it; the wrappers in
``detection_cuda``, ``align_cuda`` and ``nms_cuda`` pass tensor pointers and
PyTorch's current stream as ``c_void_p``.

Nothing is compiled or loaded at import: the first CUDA call of a wrapper
builds its kernel, and ``build()`` compiles several sources in parallel (one
``nvcc`` process each, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "frp_tpu_torch")
KERNELS = ("detection_head", "warp_crops", "greedy_nms")
# -fmad=false: every multiply and add rounds on its own, in source order, so
# the kernels' float decisions (overlap > 1.0, floor of a sample coordinate)
# match the plain PyTorch versions', which never contract
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda)")


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC_DIR)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC_DIR, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=KERNELS) -> dict[str, float]:
    """Compile the named kernels that are not built yet, all at once.
    Returns {name: seconds} for the ones compiled; raises with nvcc's output
    when one fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        nvcc = nvcc or nvcc_path()
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    times, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build((name,))
            lib = _libs[name] = ctypes.CDLL(path)
        return lib


def check(err: int, what: str) -> None:
    """Raise when a kernel's C entry reports a CUDA error (its launch was
    refused or its arguments rejected)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
