"""Build, load and launch the port's hand-written CUDA kernels
(``frp_tpu_torch/csrc``).

Each kernel source is one ``.cu`` file with a plain C interface. ``nvcc``
compiles it for Hopper (``sm_90a``) into a shared library under
``build/frp_tpu_torch/`` at the repository root (listed in ``.gitignore``),
named by a hash of the sources and flags, so an edited kernel rebuilds and an
unchanged one is reused. Each kernel is declared once, as a ``Kernel`` at
module level in its wrapper ``ops/*_cuda.py``: its C entry's argument types
and whether a launch keeps the interpreter lock. Calling the declaration
launches the kernel with tensor pointers and PyTorch's current stream as
``c_void_p``, and counts the launch.

Nothing is compiled or loaded at import. ``build()`` compiles several sources
in parallel (one ``nvcc`` process each, all started together); the first
launch of a kernel that is not built yet builds every kernel of ``KERNELS``
(every ``csrc/*.cu``) not built yet, in one such round.

The host library ``csrc/framepack.cpp`` (the frame packer and change
searches of ``utils/native.py``) is built beside them by ``build_host``, with
``g++`` at its first use, named the same way by a hash of its source and
flags.
"""

from __future__ import annotations

import contextlib
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
KERNELS = tuple(sorted(fn[:-3] for fn in os.listdir(CSRC_DIR) if fn.endswith(".cu")))
# -fmad=false: every multiply and add rounds on its own, in source order, so
# the kernels' float decisions (overlap > 1.0, floor of a sample coordinate)
# match the plain PyTorch versions', which never contract
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

GXX_FLAGS = ("-O2", "-shared", "-fPIC")
GXX_LIBS = ("-lpthread",)

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


def host_library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS + GXX_LIBS).encode())
    with open(os.path.join(CSRC_DIR, f"{name}.cpp"), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_host(name: str) -> str:
    """The path of the host library ``csrc/{name}.cpp``, compiled with g++
    first if it is not built yet. Processes that build it at once each write
    a temporary file of their own and rename it into place, so none loads a
    half-written library; a path is never rewritten with other bytes, since
    the name changes with the source. Raises RuntimeError when g++ is
    missing or fails."""
    out = host_library_path(name)
    with _lock:
        if os.path.exists(out):
            return out
        gxx = shutil.which("g++") or shutil.which("c++")
        if gxx is None:
            raise RuntimeError("g++ not found on PATH")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        res = subprocess.run(
            [gxx, *GXX_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cpp"), *GXX_LIBS],
            capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise RuntimeError(f"{name}: g++ exited {res.returncode}\n{res.stderr}")
        os.replace(tmp, out)
        return out


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


class Kernel:
    """One hand-written kernel: the C entry ``frp_{name}`` of
    ``csrc/{name}.cu``, which takes ``argtypes`` and returns a CUDA error
    code. Calling the declaration launches the kernel: the first call loads
    the library (building every kernel not built yet, in one round) and binds
    the entry; a nonzero code raises, and each launch that returns counts in
    ``launches``.

    ``keep_gil`` loads the library as a ``ctypes.PyDLL``, whose calls hold
    the interpreter lock: a release costs the calling thread its turn beside
    a busy Python thread, which a kernel launched dozens of times a forward
    cannot afford. Otherwise it is a ``ctypes.CDLL``, whose calls release
    it. ``replaces`` names the TPU kernel of the JAX package that this one
    ports (None for a pass that replaces none)."""

    def __init__(self, name: str, argtypes, keep_gil: bool = False,
                 replaces: str | None = None):
        self.name, self.entry = name, f"frp_{name}"
        self.source = f"frp_tpu_torch/csrc/{name}.cu"
        self.argtypes, self.keep_gil, self.replaces = list(argtypes), keep_gil, replaces
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        fn = self._fn
        if fn is None:
            fn = self._fn = self._bind(self.library())
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA error {err}")
        self.launches += 1

    def library(self) -> ctypes.CDLL:
        """The loaded library, built first if needed (with every other
        kernel not built yet)."""
        with _lock:
            lib = _libs.get(self.name)
            if lib is None:
                path = library_path(self.name)
                if not os.path.exists(path):
                    build(tuple(dict.fromkeys((self.name, *KERNELS))))
                lib = _libs[self.name] = self._load(path)
            return lib

    def _load(self, path: str) -> ctypes.CDLL:
        return (ctypes.PyDLL if self.keep_gil else ctypes.CDLL)(path)

    def _bind(self, lib: ctypes.CDLL):
        fn = getattr(lib, self.entry)
        fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
        return fn

    @contextlib.contextmanager
    def using(self, path: str):
        """Launch the entry of the library at ``path`` (another build of
        this kernel, with this signature) in place of this build's, until the
        block ends."""
        own = self._fn
        self._fn = self._bind(self._load(path))
        try:
            yield
        finally:
            self._fn = own
