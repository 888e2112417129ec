"""The reference embedder of a configuration's ``embedder_arch``, and the
leaves of its seeded weights, found by name.

The networks of ``perfbench/reference/nets.py`` (``nets.EMBEDDERS``) come
first, with ``perfbench/weights.py::iresnet_leaves`` for an iresnet. Any
other architecture arrives as one new file ``<name>.py`` in this directory
that serves the names in its ``ARCHS`` tuple and defines

* ``forward(p, x, q=ident)``: normalised crops [B, 112, 112, 3] -> unit
  float32 embeddings [B, D], in plain ``torch``, every matmul or conv
  input and its weight passed through ``q`` (the control's rounding, as in
  ``nets.py``); it imports nothing of the program under test;
* ``leaves(arch, embed_dim) -> {key: (shape, kind)}``: the flat ``a/b/0/w``
  keys of the weights file in the layout the program's loader reads, each
  kind one that ``perfbench/weights.py::draw`` draws.

Its docstring names its source and every departure from it. The files here
are loaded only for a name ``nets.EMBEDDERS`` does not serve.
"""

from __future__ import annotations

import glob
import os
from typing import Callable, NamedTuple, Optional

from perfbench import common
from perfbench.reference import nets

DIR = os.path.dirname(os.path.abspath(__file__))


class Embedder(NamedTuple):
    forward: Callable
    leaves: Optional[Callable]  # None: no seeded weights can be drawn for it


def resolve(arch: str) -> Embedder:
    """The reference forward of ``arch`` and its seeded leaves."""
    if arch in nets.EMBEDDERS:
        leaves = None
        if arch in nets.IRESNET_DEPTHS:
            from perfbench.weights import iresnet_leaves

            leaves = iresnet_leaves
        return Embedder(nets.EMBEDDERS[arch], leaves)
    mods = [common._load_file(p, "perfbench_embedder_")
            for p in sorted(glob.glob(os.path.join(DIR, "*.py")))
            if not os.path.basename(p).startswith("_")]
    serving = [m for m in mods if arch in m.ARCHS]
    if len(serving) != 1:
        names = [os.path.basename(m.__file__) for m in serving]
        raise SystemExit(f"embedder_arch {arch!r}: {len(serving)} modules in {DIR} serve it "
                         f"{names}, where one must")
    return Embedder(serving[0].forward, serving[0].leaves)
