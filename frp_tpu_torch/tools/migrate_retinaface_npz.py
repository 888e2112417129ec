"""Migrate a round-2 RetinaFace checkpoint to the round-3 convention. Port of
``tools/migrate_retinaface_npz.py`` (numpy only, the same bytes out).

Round 3 fixed the FPN merge-conv convention so that the parameter list's
order is the execution order (p2's merge first, which the execution-order
ONNX import needs). Old checkpoints stored the convs under ``fpn_merge/``
with [1] executing before [0]; the engine's path-aware structure check
rejects them. This tool converts in place: swap merge 0 <-> 1, rename
``fpn_merge/`` -> ``fpn_td/``.

Usage: python -m frp_tpu_torch.tools.migrate_retinaface_npz weights/retinaface.npz
"""

from __future__ import annotations

import os
import sys

import numpy as np


def migrate(path: str) -> int:
    with np.load(path) as d:
        flat = {k: d[k] for k in d.files}
    if any(k.startswith("fpn_td/") for k in flat):
        print(f"{path}: already migrated (fpn_td/ present)")
        return 0

    def convert(key: str) -> str:
        if key.startswith("fpn_merge/0/"):
            return "fpn_td/1/" + key[len("fpn_merge/0/"):]
        if key.startswith("fpn_merge/1/"):
            return "fpn_td/0/" + key[len("fpn_merge/1/"):]
        return key

    new = {convert(k): v for k, v in flat.items()}
    changed = sum(1 for k in flat if convert(k) != k)
    if not changed:
        print(f"{path}: no fpn_merge keys found — not a RetinaFace "
              "checkpoint or already converted")
        return 1
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **new)
    os.replace(tmp, path)
    print(f"{path}: migrated {changed} keys (swap 0<->1, fpn_merge -> fpn_td)")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 2
    return max(migrate(p) for p in argv)


if __name__ == "__main__":
    sys.exit(main())
