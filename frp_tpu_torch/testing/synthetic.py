"""Synthetic face scenes for the port's smoke run, tests and synthetic camera
sources. The renderer is ``frp_tpu_torch/train/synthetic.py`` (one copy of
the JAX package's module); this module adds what that one lacks:
``write_face_clip``, an MJPG video of one moving rendered face for the
deepfake video path (it needs cv2's writer).

Scenes are RGB: a skin-tone ellipse head with two dark eyes, a nose point
and a mouth bar over a textured or plain background. The shipped detector
weights were trained on exactly this domain, so a rendered scene yields
detections where noise yields none.
"""

from __future__ import annotations

import numpy as np

from frp_tpu_torch.train.synthetic import make_identity, make_scene, render_face

__all__ = ["make_identity", "make_scene", "render_face", "write_face_clip"]


def write_face_clip(path: str, width: int, height: int, frames: int, seed: int = 0,
                    size: float | None = None) -> list[bool]:
    """Write an MJPG ``.avi`` of ``frames`` frames at 10 fps to ``path``: a
    fixed textured background (a scene's texture, seeded) and one rendered
    face of identity ``seed`` (``size`` px, ``height / 4`` by default) that
    moves from left to right; the face is gone from frames 2n/3 to
    2n/3 + n/6 (it walks out of view). cv2's own MJPG encoder needs no
    ffmpeg. Returns whether each frame holds the face."""
    import cv2

    rng = np.random.default_rng(seed)
    # a scene's texture, not iid pixel noise: noise at 1/8 of the size,
    # upsampled (MJPG compresses it as it would a camera's view)
    small = rng.integers(0, 110, size=(-(-height // 8), -(-width // 8), 3), dtype=np.uint8)
    base = cv2.resize(small, (width, height), interpolation=cv2.INTER_LINEAR)  # RGB
    size = float(size or height / 4.0)
    gone = range(frames * 2 // 3, frames * 2 // 3 + frames // 6)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (width, height))
    if not writer.isOpened():
        raise RuntimeError(f"cv2.VideoWriter could not open {path} for MJPG")
    has_face = []
    try:
        for i in range(frames):
            frame = base.copy()
            if i not in gone:
                cx = size + (width - 2 * size) * i / max(1, frames - 1)
                cy = height / 2 + 0.2 * size * np.sin(i / 3)
                # the window that holds the face renders the bytes of a
                # whole-frame render (render_face's origin)
                x0, y0 = max(0, int(cx - size)), max(0, int(cy - size))
                x1, y1 = min(width, int(cx + size) + 1), min(height, int(cy + size) + 1)
                render_face(frame[y0:y1, x0:x1], float(cx), float(cy), size,
                            np.random.default_rng(seed), identity=make_identity(seed),
                            origin=(x0, y0))
            writer.write(np.ascontiguousarray(frame[..., ::-1]))
            has_face.append(i not in gone)
    finally:
        writer.release()
    return has_face
