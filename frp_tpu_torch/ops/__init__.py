"""The port's ops. The CUDA kernels' wrapper modules each count their
launches in ``LAUNCHES``; ``launches`` and ``reset_launches`` read and clear
those counts under the kernels' names."""

from __future__ import annotations

import importlib

# kernel name -> its wrapper module in this package
KERNEL_MODULES = {"detection_head": "detection_cuda", "warp_crops": "align_cuda",
                  "greedy_nms": "nms_cuda", "bn_act": "bn_act_cuda", "add_ln": "add_ln_cuda"}


def _modules() -> dict:
    return {name: importlib.import_module(f"{__name__}.{mod}")
            for name, mod in KERNEL_MODULES.items()}


def launches() -> dict[str, int]:
    """Each kernel's launch count in this process."""
    return {name: mod.LAUNCHES for name, mod in _modules().items()}


def reset_launches() -> None:
    for mod in _modules().values():
        mod.LAUNCHES = 0
