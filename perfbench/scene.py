"""The cameras the stream traffic shows: a generator driven by a traffic
file's ``scene`` parameters and the run's seed.

Each camera is a BGR frame of noise with a grid of rendered faces, less
the walker's cell, where one face walks horizontally, ``walker_step`` px a
tick, as a sprite rendered once on its own background patch. Its path is
``walker_path``, the positions (in steps) of successive ticks, repeated;
without it, ``0 .. walker_positions - 1`` over and over, as the bench
walks. A tick's change hints are the sprite's row band, as a
video decoder gives them. The frame of any tick can be rebuilt
(``frame_at``), so the reference sees the inputs of any batch without a
copy kept in the timed path.

This is the scene of the program's own bench (``frp_tpu_torch/bench.py``,
``Scene``) with its sizes taken from the traffic file; ``render_face`` is a
frozen copy of ``frp_tpu_torch/train/synthetic.py::render_face``'s frontal
path, so the frames are the bench's bytes for the bench's parameters.
"""

from __future__ import annotations

import numpy as np


def render_face(canvas: np.ndarray, cx, cy, size, rng, origin=(0, 0)) -> None:
    """Draw one frontal synthetic face (head ellipse, eyes, nose, mouth) into
    ``canvas`` [h, w, 3] uint8, which sits at ``origin`` (x, y) of a frame
    whose coordinates ``cx``, ``cy`` are in. The arithmetic of the copied
    function at yaw, pitch and roll 0, step for step, so the same bytes."""
    h, w = canvas.shape[:2]
    gx, gy = origin
    yaw = pitch = roll = 0.0
    cyaw, cpitch = np.cos(yaw), np.cos(pitch)
    sroll, croll = np.sin(roll), np.cos(roll)
    ax = size * 0.42 * (0.70 + 0.30 * cyaw)
    ay = size * 0.55 * (0.88 + 0.12 * cpitch)
    yy, xx = np.mgrid[gy: gy + h, gx: gx + w].astype(np.float32)
    u = (xx - cx) * croll + (yy - cy) * sroll
    v = -(xx - cx) * sroll + (yy - cy) * croll
    mask = (u / ax) ** 2 + (v / ay) ** 2 <= 1.0
    skin = np.array([rng.integers(150, 220), rng.integers(110, 180), rng.integers(90, 160)])
    canvas[mask] = (0.8 * skin + 0.2 * canvas[mask]).astype(np.uint8)

    def project(x_off, y_off, depth):
        px = x_off * cyaw + depth * np.sin(yaw)
        py = y_off * cpitch - depth * np.sin(pitch)
        return (cx + px * croll - py * sroll, cy + px * sroll + py * croll)

    def blob(bx, by, r, color):
        canvas[(xx - bx) ** 2 + (yy - by) ** 2 <= r * r] = color

    eye_dx, eye_dy = size * 0.18, size * 0.12
    eye_r = max(1.5, size * 0.05)
    mouth_w, mouth_y = 0.13, 0.22
    z_eye, z_nose, z_mouth = size * 0.22, size * 0.40, size * 0.26
    blob(*project(-eye_dx, -eye_dy, z_eye), eye_r, (30, 30, 40))
    blob(*project(eye_dx, -eye_dy, z_eye), eye_r, (30, 30, 40))
    blob(*project(0.0, size * 0.05, z_nose), max(1.0, size * 0.03), (110, 80, 80))
    mc = project(0.0, size * mouth_y, z_mouth)
    um = (xx - mc[0]) * croll + (yy - mc[1]) * sroll
    vm = -(xx - mc[0]) * sroll + (yy - mc[1]) * croll
    mouth = (np.abs(um) <= size * mouth_w * cyaw) & (np.abs(vm) <= max(1.0, size * 0.025))
    canvas[mouth] = (60, 40, 120)


class Scene:
    """The cameras of one run. ``p`` is a traffic file's ``scene``."""

    def __init__(self, rng: np.random.Generator, p: dict):
        self.p = p
        h, w = p["height"], p["width"]
        rows, cols = p["grid"]
        ch, cw = h // rows, w // cols
        wr, wc = p["walker_cell"]
        sp = p["sprite"]
        self.y0 = wr * ch + ch // 2 - sp // 2
        self.x0 = wc * cw + cw // 2 - sp // 2
        cells = [(r, c) for r in range(rows) for c in range(cols) if (r, c) != (wr, wc)]
        cells = cells[: p["static_faces"]]
        lo, hi = p["background"]
        jx, jy = p["jitter"]
        smin, smax = p["face_half_size"]
        self.cams: list[np.ndarray] = []
        self.bases: list[np.ndarray] = []
        self.sprites: list[np.ndarray] = []
        self.letterboxed: dict = {}  # the reference's I420 of each distinct frame, once made
        self.path = list(p.get("walker_path") or range(p["walker_positions"]))
        self.tick = 0
        for _ in range(p["cameras"]):
            rgb = rng.integers(lo, hi, size=(h, w, 3), dtype=np.uint8)
            for r, c in cells:
                size = float(rng.uniform(smin, smax))
                cx = c * cw + cw // 2 + float(rng.uniform(-jx, jx))
                cy = r * ch + ch // 2 + float(rng.uniform(-jy, jy))
                x0, y0 = max(0, int(cx - size)), max(0, int(cy - size))
                x1, y1 = min(w, int(cx + size) + 1), min(h, int(cy + size) + 1)
                render_face(rgb[y0:y1, x0:x1], cx, cy, size, rng, origin=(x0, y0))
            bgr = np.ascontiguousarray(rgb[..., ::-1])  # BGR, as cv2 delivers
            base = bgr.copy()
            sprite = np.ascontiguousarray(base[self.y0: self.y0 + sp, self.x0: self.x0 + sp][..., ::-1])
            render_face(sprite, sp // 2, sp // 2, float(p["walker_face"]), rng)
            self.bases.append(base)
            self.sprites.append(np.ascontiguousarray(sprite[..., ::-1]))
            self.cams.append(bgr)

    @property
    def period(self) -> int:
        """Ticks after which every camera's frame repeats."""
        return len(self.path)

    def _dx(self, tick: int) -> int:
        return self.path[tick % len(self.path)] * self.p["walker_step"]

    def phase(self, tick: int) -> int:
        """The walker's position at ``tick``: frames of one phase are equal."""
        return self.path[tick % len(self.path)]

    def advance(self) -> list:
        """Move every camera's walker to the next tick; returns each camera's
        changed source row bands."""
        t = self.tick
        self.tick += 1
        sp, y0 = self.p["sprite"], self.y0
        bands = []
        for cam, base, sprite in zip(self.cams, self.bases, self.sprites):
            if t > 0:
                x = self.x0 + self._dx(t - 1)
                cam[y0: y0 + sp, x: x + sp] = base[y0: y0 + sp, x: x + sp]
            x = self.x0 + self._dx(t)
            cam[y0: y0 + sp, x: x + sp] = sprite
            bands.append([(y0, y0 + sp)])
        return bands

    def frame_at(self, cam: int, tick: int | None) -> np.ndarray:
        """Camera ``cam``'s frame after ``advance`` ran for ``tick`` (None:
        before the first advance, no walker)."""
        out = self.bases[cam].copy()
        if tick is not None:
            sp, x = self.p["sprite"], self.x0 + self._dx(tick)
            out[self.y0: self.y0 + sp, x: x + sp] = self.sprites[cam]
        return out


def union_ranges(hints: list):
    """The union of block-range hints (lists of half-open (b0, b1)), merged
    and sorted; None where any of them is None (unknown: diff everything)."""
    spans = []
    for h in hints:
        if h is None:
            return None
        spans.extend(h)
    out: list = []
    for a, z in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], z))
        else:
            out.append((a, z))
    return out


def gallery(rng: np.random.Generator, n: int, dim: int, anchors=None, distances=None,
            scale: float = 1.0) -> np.ndarray:
    """``n`` unit entries [n, dim] float32. Without ``anchors`` all random.
    With them, entry j < len(anchors) lies at euclidean distance
    ``distances[j]`` from ``scale`` times anchor j (a unit embedding), in a
    random direction (at |1 - scale| where it asks for less: no unit entry
    is nearer); the rest are random."""
    g = rng.normal(size=(n, dim))
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    for j, (a, d) in enumerate(zip(anchors if anchors is not None else [], distances or [])):
        a = np.asarray(a, np.float64) / np.linalg.norm(a)
        u = g[j] - (g[j] @ a) * a
        u /= np.linalg.norm(u)
        # |scale * a - g| = d for g = cos(t) a + sin(t) u
        c = float(np.clip((scale * scale + 1.0 - d * d) / (2.0 * scale), -1.0, 1.0))
        g[j] = c * a + np.sqrt(1.0 - c * c) * u
    return g.astype(np.float32)
