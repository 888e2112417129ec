"""PyTorch port, the seam of the hand-written CUDA kernels, on the CPU: each
``csrc/*.cu`` is declared once, as ``KERNEL`` (a ``cuda_build.Kernel``) in
its wrapper ``ops/*_cuda.py``, and everything else reads that declaration:
the build list, the library's ``ctypes`` type, the launch and its count,
and the A/B tool's swap of another build."""

import ctypes
import importlib
import os
import pkgutil
import re
import subprocess

import pytest

import frp_tpu_torch
from frp_tpu_torch import ops
from frp_tpu_torch.ops import cuda_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = sorted(fn[:-3] for fn in os.listdir(cuda_build.CSRC_DIR) if fn.endswith(".cu"))
# the passes launched dozens of times a forward keep the interpreter lock
KEEP_GIL = {"bn_act", "add_ln"}


def _wrappers() -> list:
    return [importlib.import_module(f"frp_tpu_torch.ops.{m.name}")
            for m in pkgutil.iter_modules(ops.__path__) if m.name.endswith("_cuda")]


@pytest.mark.parametrize("name", SOURCES)
def test_each_kernel_source_has_one_declaration(name, monkeypatch):
    """One ``Kernel`` of this name in all of ``ops/``, at its wrapper's
    ``KERNEL``; the build list is the sources; the library loads as a
    ``ctypes.PyDLL`` where the declaration keeps the interpreter lock and as
    a ``ctypes.CDLL`` elsewhere."""
    assert cuda_build.KERNELS == tuple(SOURCES)
    found = [(mod.__name__, v) for mod in _wrappers() for v in vars(mod).values()
             if isinstance(v, cuda_build.Kernel) and v.name == name]
    assert len(found) == 1, found
    mod, k = found[0]
    assert importlib.import_module(mod).KERNEL is k and ops.kernels()[name] is k
    assert set(ops.kernels()) == set(SOURCES)
    assert k.entry == f"frp_{name}" and k.keep_gil == (name in KEEP_GIL)
    assert os.path.exists(os.path.join(REPO, k.source))
    # load a host library in the kernel's place: no nvcc here
    host = cuda_build.build_host("framepack")
    monkeypatch.setattr(cuda_build, "library_path", lambda _: host)
    monkeypatch.setattr(cuda_build, "_libs", {})
    assert type(k.library()) is (ctypes.PyDLL if name in KEEP_GIL else ctypes.CDLL)


def test_nothing_reaches_into_a_declarations_binding():
    """Only ``cuda_build`` touches a declaration's bound entry; no wrapper
    keeps a binding or a count of its own."""
    root = os.path.dirname(frp_tpu_torch.__file__)
    files = [os.path.join(d, fn) for d, _, fns in os.walk(root) for fn in fns if fn.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    private = re.compile(r"\._fn\b|\._kernel\(")
    own = re.compile(r"^_fn\b|^def _kernel\(|global LAUNCHES|^LAUNCHES\b", re.M)
    for path in files:
        with open(path) as f:
            src = f.read()
        if os.path.basename(path) != "cuda_build.py":
            assert not private.search(src), path
        if path.endswith("_cuda.py"):
            assert not own.search(src), path


def test_a_declaration_launches_counts_raises_and_swaps(tmp_path, monkeypatch):
    """Calling a declaration builds, binds once and counts each launch that
    returns 0; a nonzero code raises and is not counted; ``using`` launches
    another build's entry until its block ends, then this build's again."""
    libs = {}
    for tag, body in (("this", "return code;"), ("other", "return code == 7 ? 0 : 1;")):
        src = tmp_path / f"{tag}.c"
        src.write_text(f"int frp_probe(int code) {{ {body} }}\n")
        libs[tag] = str(tmp_path / f"lib{tag}.so")
        subprocess.run(["gcc", "-shared", "-fPIC", "-o", libs[tag], str(src)], check=True,
                       timeout=60)
    built = []
    monkeypatch.setattr(cuda_build, "library_path", lambda name: libs["this"])
    monkeypatch.setattr(cuda_build, "build", lambda names: built.append(names))
    monkeypatch.setattr(cuda_build, "_libs", {})
    k = cuda_build.Kernel("probe", [ctypes.c_int])
    k(0)
    k(0)
    assert k.launches == 2 and not built
    with pytest.raises(RuntimeError, match="probe: CUDA error 3"):
        k(3)
    assert k.launches == 2
    with k.using(libs["other"]):
        k(7)
        with pytest.raises(RuntimeError, match="probe: CUDA error 1"):
            k(0)
    k(0)
    with pytest.raises(RuntimeError, match="probe: CUDA error 7"):
        k(7)
    assert k.launches == 4
