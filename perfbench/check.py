"""The comparison that decides ``correct``: the program's results of a
sample of the window's batches against the plain reference's on the same
camera frames, and the frames resident on the device against the
reference's letterbox.

Faces are paired frame by frame: each reference face, in rank order, with
the unpaired program face of the largest IoU, at least ``PAIR_IOU``.

Discrete answers, an exact comparison (limit 0), ``answers_off`` counts:

- a face either side finds no partner for, with a score clear of the
  detection threshold by ``MARGIN`` (a bfloat16 score moves by 0.02 at
  most on the card, so a face this clear of the threshold is no tie);
- a pair whose program picked a gallery entry more than ``PICK_SLACK``
  beyond the nearest one in the reference's distances (a nearer pick is a
  near tie that rounding may flip);
- a pair whose match decision disagrees with the reference's distance to
  the picked entry, where that distance is clear of the tolerance by
  ``PICK_SLACK``.

The embedder and the spoof net are judged on the crops they were given:
the reference's distances and spoof probability of a pair are those of the
crop cut at the program's own landmarks (``Reference.faces``' ``judged``),
while the landmarks themselves are judged by ``ldm``. Against the
reference's own crop, a detector's tie would be judged twice: where a
bfloat16 detector keeps a neighbouring anchor of equal score, its
landmarks move 2-3 px, and a crop cut there moved a sound pick 0.107
beyond the nearest entry.

Precision, each the median (``_p50``) and the 90th percentile (``_p90``)
over the pairs: ``box`` and ``ldm``, a pair's largest coordinate gap in
detector pixels; ``score``, the gap of the detection score; ``dist``, the
gap between the program's best distance and the reference's distance to
the same entry; ``fake``, the gap of the spoof probability's log-odds. Not
the largest: the largest gaps of a bfloat16 run are its anchor ties, where
the program keeps a neighbouring anchor of equal score, and read as high as
the fp8 control's. The median reads the arithmetic's own error over
hundreds of faces; the 90th percentile also fails a fault on a tenth of
them or more.

``frame_off``: resident I420 bytes that differ from the reference's
letterbox; an exact comparison, limit 0.

The largest gaps (``box_max``, ``ldm_max``, ``score_max``, ``dist_max``,
``fake_max``, ``idx_gap_max``) are reported beside them and decide nothing,
as do ``matched`` (pairs whose nearest entry is within the tolerance in the
reference) and ``decided`` (pairs whose match decision was held).
"""

from __future__ import annotations

import numpy as np

PAIR_IOU = 0.5
MARGIN = 0.05
PICK_SLACK = 0.1
GAPS = ("box", "ldm", "score", "dist", "fake")
ORDER = ("frame_off", "answers_off") + tuple(f"{k}_{q}" for q in ("p50", "p90") for k in GAPS)


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[n, 4] x [m, 4] xyxy -> [n, m] IoU."""
    ix = np.clip(np.minimum(a[:, None, 2], b[None, :, 2]) - np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    iy = np.clip(np.minimum(a[:, None, 3], b[None, :, 3]) - np.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = ix * iy

    def area(x):
        return np.clip(x[:, 2] - x[:, 0], 0, None) * np.clip(x[:, 3] - x[:, 1], 0, None)

    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter, 1e-12)


def log_odds(p) -> float:
    p = min(max(float(p), 1e-7), 1.0 - 1e-7)
    return float(np.log(p / (1.0 - p)))


def landmarks(result: dict) -> list:
    """A frame's [n, 10] landmarks of the valid faces of a result dict, in
    slot order: what ``Reference.faces`` cuts the judged crops at."""
    return [np.asarray(lm, np.float32)[np.asarray(v, bool)]
            for lm, v in zip(result["landmarks"], result["valid"])]


def compare(programs: list, references: list, cfg: dict) -> dict:
    """``programs``: the program's result dicts of the sampled batches
    (boxes [B, M, 4], landmarks, scores, valid, best_idx, best_distance,
    is_match, fake_prob); ``references``: for each, a list a frame of the
    reference's faces (``Reference.faces`` with the program's
    ``landmarks``). Returns the numbers of ``ORDER`` but ``frame_off``, the
    largest gaps, and ``faces``, the pairs compared."""
    conf, tol = cfg["conf_thresh"], cfg["tolerance"]
    gaps: dict = {k: [] for k in GAPS}
    idx_gap = 0.0
    matched = decided = 0
    why: list = []  # the first answers off, for the run's log
    for prog, ref_frames in zip(programs, references):
        for f, ref in enumerate(ref_frames):
            v = np.asarray(prog["valid"][f], bool)
            pidx = np.nonzero(v)[0]
            pb, rb = np.asarray(prog["boxes"][f])[v], ref["boxes"]
            iou = _iou(rb, pb) if len(rb) and len(pb) else np.zeros((len(rb), len(pb)))
            used: set = set()
            for r in np.argsort(-ref["scores"], kind="stable"):
                cand = [j for j in np.argsort(-iou[r], kind="stable")
                        if j not in used and iou[r, j] >= PAIR_IOU] if len(pb) else []
                if not cand:
                    if ref["scores"][r] >= conf + MARGIN:
                        why.append(("face missing", f, round(float(ref["scores"][r]), 4)))
                    continue
                j = cand[0]
                used.add(j)
                m = pidx[j]
                gaps["box"].append(float(np.abs(pb[j] - rb[r]).max()))
                gaps["ldm"].append(float(np.abs(np.asarray(prog["landmarks"][f][m])
                                                - ref["landmarks"][r]).max()))
                gaps["score"].append(abs(float(prog["scores"][f][m]) - float(ref["scores"][r])))
                judged = ref["judged"]
                gaps["fake"].append(abs(log_odds(prog["fake_prob"][f][m])
                                        - log_odds(judged["fake_prob"][j])))
                rd = judged["distances"][j]
                bi = int(prog["best_idx"][f][m])
                if not 0 <= bi < len(rd):
                    why.append(("entry out of range", f, bi))
                    continue
                gaps["dist"].append(abs(float(prog["best_distance"][f][m]) - float(rd[bi])))
                g = float(rd[bi] - rd.min())
                idx_gap = max(idx_gap, g)
                if g > PICK_SLACK:
                    why.append(("pick beyond the nearest", f, bi, round(g, 4)))
                matched += bool(rd.min() <= tol)
                if abs(rd[bi] - tol) > PICK_SLACK:
                    decided += 1
                    if bool(prog["is_match"][f][m]) != bool(rd[bi] <= tol):
                        why.append(("match decision", f, bi, round(float(rd[bi]), 4)))
            why += [("face extra", f, round(float(prog["scores"][f][pidx[j]]), 4))
                    for j in range(len(pb))
                    if j not in used and float(prog["scores"][f][pidx[j]]) >= conf + MARGIN]
    out = {"answers_off": len(why), "faces": len(gaps["box"]), "idx_gap_max": idx_gap,
           "matched": matched, "decided": decided, "why": why[:10]}
    for k, vals in gaps.items():
        out[f"{k}_p50"] = float(np.median(vals)) if vals else 0.0
        out[f"{k}_p90"] = float(np.quantile(vals, 0.9)) if vals else 0.0
        out[f"{k}_max"] = float(np.max(vals)) if vals else 0.0
    return out


def frame_off(resident: np.ndarray, reference: np.ndarray) -> int:
    """Bytes of the resident I420 batch that differ from the reference's."""
    return int((resident != reference).sum())


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(every number within its limit, [[name, number, limit], ...] in
    ``ORDER``). A number above its limit, or not a finite number, fails."""
    rows, ok = [], True
    for name in ORDER:
        if name not in limits:
            continue
        val = numbers.get(name)
        lim = limits[name]
        good = val is not None and np.isfinite(val) and val <= lim
        ok = ok and bool(good)
        rows.append([name, val, lim])
    return ok, rows


def as_results(frames: list, cfg: dict) -> dict:
    """The reference's faces of a batch (``Reference.faces``) in the layout
    of the program's results, [B, M, ...] with a valid mask: the control
    put in the program's place."""
    b, m = len(frames), cfg["max_faces"]
    out = {"boxes": np.zeros((b, m, 4)), "landmarks": np.zeros((b, m, 10)),
           "scores": np.zeros((b, m)), "valid": np.zeros((b, m), bool),
           "best_idx": np.zeros((b, m), np.int64), "best_distance": np.full((b, m), np.inf),
           "is_match": np.zeros((b, m), bool), "fake_prob": np.zeros((b, m))}
    for f, fr in enumerate(frames):
        n = len(fr["scores"])
        out["valid"][f, :n] = True
        for key in ("boxes", "landmarks", "scores", "fake_prob"):
            out[key][f, :n] = fr[key]
        if n:
            out["best_idx"][f, :n] = fr["distances"].argmin(1)
            out["best_distance"][f, :n] = fr["distances"].min(1)
            out["is_match"][f, :n] = out["best_distance"][f, :n] <= cfg["tolerance"]
    return out
