"""Weights-file fingerprinting for calibration provenance.

The distance-scale calibration (tools/calibrate_embedder.py) is a property
of ONE set of embedder weights; applying it to different weights silently
distorts every distance band the reference's 0.3/0.4/0.6 constants depend
on (reference face_service.py:352-364,395-443,486-506). Round 4 shipped
exactly that drift: a retrained iresnet18.npz with the previous weights'
calibration (ADVICE r4, severity high). Calibration artifacts now carry
the sha256 of the weights file they were measured on, and the engine
refuses to apply a calibration whose fingerprint does not match the
weights it actually loaded.

The PyTorch port's copy of ``frp_tpu/utils/fingerprint.py``.
"""

from __future__ import annotations

import hashlib


def weights_fingerprint(path: str) -> str:
    """sha256 hex digest of the weights file's bytes (full digest; ~0.2 s
    for the 57 MB iresnet18 npz — engine init pays it once per process)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
