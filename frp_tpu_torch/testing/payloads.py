"""Seeded inputs for the detection head (``ops/detection_cuda.py``) that the
rendered scenes do not give: a crowd of overlapping candidates."""

from __future__ import annotations

import numpy as np


def crowd_payload(rng: np.random.Generator, b: int, k: int, n_above: int,
                  scattered: bool = False) -> np.ndarray:
    """Candidate payload [b, k, 19] f32 (0:4 loc deltas, 4:14 landmark deltas,
    14:18 prior cx cy w h, 18 score) of a crowd: priors of 50 to 130 px (at
    det 640) scattered 25 px around four centres a frame, so that a large
    share of the pairs overlap. Rows are sorted by score; the first n_above
    score in [0.5, 1), the rest below 0.25.

    `scattered` shuffles each frame's rows, so that the payload is not sorted
    and the rows above 0.5 are no prefix; they then all score 0.9, so that
    slots filled by score with ties in row order are slots filled in row
    order."""
    centres = rng.uniform(0.25, 0.75, (b, 4, 2))
    cxy = np.take_along_axis(centres, rng.integers(0, 4, (b, k, 1)), 1) + rng.normal(0, 0.04, (b, k, 2))
    score = np.concatenate([-np.sort(-rng.uniform(0.5, 1.0, (b, n_above)), axis=1),
                            -np.sort(-rng.uniform(0.0, 0.25, (b, k - n_above)), axis=1)], 1)
    payload = np.concatenate([rng.normal(0, 0.4, (b, k, 4)), rng.normal(0, 0.4, (b, k, 10)),
                              cxy, rng.uniform(0.08, 0.2, (b, k, 2)), score[..., None]], -1)
    if scattered:
        payload[:, :n_above, 18] = 0.9
        payload = np.stack([frame[rng.permutation(k)] for frame in payload])
    return payload.astype(np.float32)
