"""Synthetic face scenes for the port's smoke run and tests: a numpy copy of
``make_scene`` (frontal domain) and ``render_face`` from
``frp_tpu/train/synthetic.py``, the parts that run without cv2.

Scenes are RGB: a skin-tone ellipse head with two dark eyes, a nose point
and a mouth bar over a textured or plain background. The shipped detector
weights were trained on exactly this domain, so a rendered scene yields
detections where noise yields none.
"""

from __future__ import annotations

import numpy as np


def render_face(
    canvas: np.ndarray, cx, cy, size, rng,
    identity: dict | None = None,
    pose: tuple | None = None,
    occlusion: float = 0.0,
):
    """Draw one synthetic face; returns (bbox xyxy px, landmarks 10 px).

    With ``identity`` (see make_identity) the face is person-stable; otherwise
    colors come from ``rng`` with the standard geometry. ``pose`` is
    (yaw, pitch, roll) radians: features are placed by projecting their 3-D
    head offsets (eyes/nose/mouth protrude from the head sphere, so yaw slides
    them toward the turn direction and foreshortens lateral spacing — the same
    geometry a rotated real head projects to). ``occlusion`` > 0 covers that
    fraction of the face box with an opaque patch (scarf/pole/hand stand-in);
    landmarks still report the unoccluded positions, as real annotations do.
    ``pose=None`` is byte-identical to the round-2 frontal renderer."""
    h, w = canvas.shape[:2]
    ident = identity or {}
    yaw, pitch, roll = pose if pose is not None else (0.0, 0.0, 0.0)
    cyaw, cpitch = np.cos(yaw), np.cos(pitch)
    sroll, croll = np.sin(roll), np.cos(roll)
    ax = size * ident.get("head_ax", 0.42) * (0.70 + 0.30 * cyaw)
    ay = size * ident.get("head_ay", 0.55) * (0.88 + 0.12 * cpitch)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    # head ellipse in roll-rotated coordinates
    u = (xx - cx) * croll + (yy - cy) * sroll
    v = -(xx - cx) * sroll + (yy - cy) * croll
    mask = (u / ax) ** 2 + (v / ay) ** 2 <= 1.0
    skin = ident.get(
        "skin",
        np.array([rng.integers(150, 220), rng.integers(110, 180), rng.integers(90, 160)]),
    )
    canvas[mask] = (0.8 * skin + 0.2 * canvas[mask]).astype(np.uint8)

    def project(x_off, y_off, depth):
        """3-D feature offset -> screen position under (yaw, pitch, roll)."""
        px = x_off * cyaw + depth * np.sin(yaw)
        py = y_off * cpitch - depth * np.sin(pitch)
        return (cx + px * croll - py * sroll, cy + px * sroll + py * croll)

    def blob(bx, by, r, color):
        m = (xx - bx) ** 2 + (yy - by) ** 2 <= r * r
        canvas[m] = color

    eye_dx = size * ident.get("eye_dx", 0.18)
    eye_dy = size * ident.get("eye_dy", 0.12)
    eye_r = max(1.5, size * ident.get("eye_r", 0.05))
    eye_color = ident.get("eye_color", (30, 30, 40))
    mouth_w = ident.get("mouth_w", 0.13)
    mouth_y = ident.get("mouth_y", 0.22)
    mouth_color = ident.get("mouth_color", (60, 40, 120))
    z_eye, z_nose, z_mouth = size * 0.22, size * 0.40, size * 0.26
    le = project(-eye_dx, -eye_dy, z_eye)
    re = project(eye_dx, -eye_dy, z_eye)
    nose = project(0.0, size * 0.05, z_nose)
    ml = project(-size * mouth_w * 0.92, size * mouth_y, z_mouth)
    mr = project(size * mouth_w * 0.92, size * mouth_y, z_mouth)
    blob(*le, eye_r, eye_color)
    blob(*re, eye_r, eye_color)
    blob(*nose, max(1.0, size * 0.03), (110, 80, 80))
    mc = project(0.0, size * mouth_y, z_mouth)
    um = (xx - mc[0]) * croll + (yy - mc[1]) * sroll
    vm = -(xx - mc[0]) * sroll + (yy - mc[1]) * croll
    mouth = (np.abs(um) <= size * mouth_w * cyaw) & (
        np.abs(vm) <= max(1.0, size * 0.025)
    )
    canvas[mouth] = mouth_color

    # bbox of the rotated head ellipse
    bx = float(np.sqrt((ax * croll) ** 2 + (ay * sroll) ** 2))
    by = float(np.sqrt((ax * sroll) ** 2 + (ay * croll) ** 2))
    box = [cx - bx, cy - by, cx + bx, cy + by]
    ldm = [*le, *re, *nose, *ml, *mr]

    if occlusion > 0.0:
        frac = float(rng.uniform(0.4, 1.0)) * occlusion
        area = (2 * bx) * (2 * by) * frac
        aspect = float(rng.uniform(0.3, 3.0))
        ow = max(2.0, np.sqrt(area * aspect))
        oh = max(2.0, area / ow)
        ox = float(rng.uniform(cx - bx, cx + bx - ow * 0.5))
        oy = float(rng.uniform(cy - by, cy + by - oh * 0.5))
        x0, x1 = max(0, int(ox)), min(w, int(ox + ow))
        y0, y1 = max(0, int(oy)), min(h, int(oy + oh))
        if x1 > x0 and y1 > y0:
            shade = rng.integers(0, 90) if rng.random() < 0.7 else rng.integers(160, 255)
            canvas[y0:y1, x0:x1] = np.clip(
                int(shade) + rng.integers(-15, 16, 3), 0, 255
            ).astype(np.uint8)
    return box, ldm


def make_scene(size: int, rng, max_faces: int = 3, portrait: bool = False):
    """One frontal-domain scene (``difficulty=None`` in the JAX package: the
    same draws from ``rng``, so the same scene). Returns (image [S,S,3]
    uint8, boxes [G,4] norm, ldm [G,10] norm, valid [G]) with G = max_faces
    padding. ``portrait`` forces the enroll-upload shape: exactly one face at
    0.45-0.75 of the square, plain background half the time."""
    # 25% plain backgrounds (flat wall / soft gradient): the enroll-upload
    # domain. Trained only on noise+clutter, the detector emits clusters of
    # shifted undersized duplicates on a flat-background portrait (measured:
    # 4-16 boxes for one face) — plain scenes teach localization without
    # texture anchoring.
    plain = rng.random() < (0.5 if portrait else 0.25)
    if plain:
        base = int(rng.integers(25, 215))
        img = np.full((size, size, 3), base, np.uint8)
        if rng.random() < 0.5:  # soft vertical illumination gradient
            g = np.linspace(
                0, float(rng.uniform(-40, 40)), size, dtype=np.float32
            )[:, None, None]
            img = np.clip(img.astype(np.float32) + g, 0, 255).astype(np.uint8)
    else:
        img = rng.integers(20, 120, size=(size, size, 3), dtype=np.uint8)
    # background clutter (plain scenes stay mostly clean — at most one patch)
    for _ in range(rng.integers(0, 2) if plain else rng.integers(2, 6)):
        x0, y0 = rng.integers(0, size, 2)
        wdt, hgt = rng.integers(5, size // 3, 2)
        img[y0 : y0 + hgt, x0 : x0 + wdt] = rng.integers(0, 255, 3)

    # 20% of scenes are face-free negatives — without them the detector
    # hallucinates extra boxes on background texture
    if portrait:
        n = 1
    else:
        n = 0 if rng.random() < 0.2 else int(rng.integers(1, max_faces + 1))
    boxes = np.zeros((max_faces, 4), np.float32)
    ldms = np.zeros((max_faces, 10), np.float32)
    valid = np.zeros((max_faces,), bool)
    placed = []
    for k in range(n):
        # single-face scenes span up to closeup-portrait scale (enroll
        # uploads letterbox a mostly-face photo to the det square — round-3
        # probe: the 0.12-0.4 training cap made 300px+ faces miss or
        # double-detect); crowded scenes keep the surveillance range
        hi = 0.75 if n == 1 else 0.4
        if n == 1 and (portrait or rng.random() < 0.4):
            # portrait band oversampled: uniform(0.12, 0.75) gives closeups
            # only ~40% of single-face scenes and the 300px+ regression stays
            # sloppy (shifted duplicate clusters; see the plain-bg note above)
            fsize = float(rng.uniform(size * 0.45, size * hi))
        else:
            fsize = float(rng.uniform(size * 0.12, size * hi))
        for _ in range(10):  # rejection-sample non-overlapping placement
            # closeup faces can invert the placement band (0.7*fsize >
            # size - 0.7*fsize); order the bounds so the center just sits
            # in the middle band instead of raising
            x_lo, x_hi = sorted((fsize * 0.6, size - fsize * 0.6))
            y_lo, y_hi = sorted((fsize * 0.7, size - fsize * 0.7))
            cx = float(rng.uniform(x_lo, x_hi))
            cy = float(rng.uniform(y_lo, y_hi))
            if all(abs(cx - px) + abs(cy - py) > fsize + ps for px, py, ps in placed):
                break
        else:
            continue
        placed.append((cx, cy, fsize))
        box, ldm = render_face(img, cx, cy, fsize, rng)
        boxes[k] = np.asarray(box, np.float32) / size
        ldms[k] = np.asarray(ldm, np.float32) / size
        valid[k] = True
    return img, boxes, ldms, valid
