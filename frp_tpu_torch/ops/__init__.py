"""The port's ops. Each hand-written CUDA kernel is declared once, as
``KERNEL`` (a ``cuda_build.Kernel``) in its wrapper module ``ops/*_cuda.py``;
``kernels`` finds the declarations, and ``launches`` and ``reset_launches``
read and clear their launch counts under the kernels' names."""

from __future__ import annotations

import functools
import importlib
import pkgutil


@functools.cache
def kernels() -> dict:
    """Every kernel's declaration by name, in name order; the wrapper
    modules are imported here if they were not yet."""
    found = [importlib.import_module(f"{__name__}.{m.name}").KERNEL
             for m in pkgutil.iter_modules(__path__) if m.name.endswith("_cuda")]
    return {k.name: k for k in sorted(found, key=lambda k: k.name)}


def launches() -> dict[str, int]:
    """Each kernel's launch count in this process."""
    return {name: k.launches for name, k in kernels().items()}


def reset_launches() -> None:
    for k in kernels().values():
        k.launches = 0
