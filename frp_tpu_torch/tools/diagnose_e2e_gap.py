"""Attribute the hard-tier crop-vs-e2e TPR gap. Port of
``tools/diagnose_e2e_gap.py``: the same renders, the same three paths, the
same metrics and file fields, on the port's engine.

The serving path adds a gap between crop-level TPR@0.6 and end-to-end
TPR@0.6 on the hard tier. This tool splits it into its two candidate causes
by embedding the SAME scenes along three paths:

  A  engine e2e            detector landmarks, letterboxed det-640 source
                           (exactly the serving path: kernels 1 and 2 on
                           the card)
  C  GT landmarks @ 640    ground-truth renderer landmarks mapped through
                           the letterbox transform, warped on the host from
                           the same letterboxed image: detector noise
                           removed, serving resolution kept
  B  GT landmarks @ 1080p  warped on the host from the native frame:
                           detector noise AND letterbox decimation removed

A < C  => detector landmark/alignment noise costs TPR;
C < B  => the 640 letterbox's resolution loss costs TPR (only det-size or
          multi-scale serving can recover it);
B < crop-eval => residual scene effects (backlight gradients, motion blur
          rendered at scene scale).

Also reports the detector's mean/median/p90 5-point landmark error in
det-640 pixels against the ground truth (the best-scoring valid slot).

Usage: python -m frp_tpu_torch.tools.diagnose_e2e_gap [--arch iresnet18]
           [--tier 2] [--identities 20] [--variants 4] [--out PATH]
           [--device cuda|cpu]
Writes build/frp_tpu_torch/e2e_gap_profile.json unless --out names a file.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from frp_tpu_torch.ops.cuda_build import BUILD_DIR

SEED = 9300  # same held-out identity range as tiered_eval
DEFAULT_OUT = os.path.join(BUILD_DIR, "e2e_gap_profile.json")


def similarity_np(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Host port of ops.align.similarity_transform for one [5,2] pair."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    var_s = max(float((sc * sc).sum()), 1e-12)
    a = float((sc * dc).sum()) / var_s
    b = float((sc[:, 0] * dc[:, 1] - sc[:, 1] * dc[:, 0]).sum()) / var_s
    rot = np.array([[a, -b], [b, a]], np.float32)
    t = mu_d - rot @ mu_s
    return np.concatenate([rot, t[:, None]], axis=1)  # [2, 3]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="iresnet18")
    p.add_argument("--tier", type=int, default=2)
    p.add_argument("--identities", type=int, default=20)
    p.add_argument("--variants", type=int, default=4)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def render_scenes(identities: int, variants: int, tier: int):
    """One-face 1080p BGR scenes at ``tier`` with their ground-truth
    landmarks [5, 2] and identity labels."""
    from frp_tpu_torch.train.synthetic import (
        TIERS,
        apply_photometric,
        make_identity,
        render_face,
        sample_pose,
    )

    rng = np.random.default_rng(SEED)
    h, w = 1080, 1920
    scenes, gt_lms, labels = [], [], []
    for i in range(identities):
        ident = make_identity(SEED + i)
        for _ in range(variants):
            rgb = rng.integers(20, 110, size=(h, w, 3), dtype=np.uint8)
            occ = TIERS[tier]["occ"]
            _box, lm10 = render_face(
                rgb,
                w / 2 + float(rng.uniform(-w / 8, w / 8)),
                h / 2 + float(rng.uniform(-h / 8, h / 8)),
                float(rng.uniform(170, 240)),
                rng,
                identity=ident,
                pose=sample_pose(rng, tier),
                occlusion=occ if (occ and rng.random() < 0.5) else 0.0,
            )
            rgb = apply_photometric(rgb, rng, tier)
            scenes.append(np.ascontiguousarray(rgb[..., ::-1]))  # BGR
            gt_lms.append(np.asarray(lm10, np.float32).reshape(5, 2))
            labels.append(i)
    return scenes, gt_lms, np.asarray(labels, np.int64)


def main(argv=None) -> dict:
    args = parse_args(argv)
    t0 = time.perf_counter()

    import cv2

    from frp_tpu_torch.config import load_config
    from frp_tpu_torch.engine.batching import build_batch_i420, letterbox
    from frp_tpu_torch.engine.pipeline import RecognitionEngine, resolve_device
    from frp_tpu_torch.ops.align import ARCFACE_TEMPLATE_112
    from frp_tpu_torch.tools.calibrate_embedder import backend_name
    from frp_tpu_torch.train.pairs import embed_crops, pair_distances, threshold_metrics

    device = resolve_device(args.device)
    scenes, gt_lms, labels = render_scenes(args.identities, args.variants, args.tier)

    eng = RecognitionEngine(load_config(
        det_size=640, max_faces_per_frame=16, embedder_arch=args.arch,
    ), device=device)
    det = eng.cfg.det_size
    tmpl = np.asarray(ARCFACE_TEMPLATE_112, np.float32)

    # ---- path A: engine e2e (serving path), collecting detector landmarks;
    # process_frames keeps them in det-640 coordinates
    embs_a, labs_a, lm_err = [], [], []
    bsz = 8
    for i in range(0, len(scenes), bsz):
        chunk = scenes[i : i + bsz]
        batch, meta = build_batch_i420(
            {j: f for j, f in enumerate(chunk)}, det, slots=bsz
        )
        out = eng.process_frames(batch, fmt="yuv420")
        for j in range(len(chunk)):
            valid = out["valid"][j]
            if not valid.any():
                continue
            k = int(np.argmax(np.where(valid, out["scores"][j], -1.0)))
            embs_a.append(out["embeddings"][j, k])
            labs_a.append(labels[i + j])
            # GT landmarks mapped into det coords via this frame's letterbox
            s, (ox, oy) = meta.scales[j], meta.offsets[j]
            gt640 = gt_lms[i + j] * s + np.asarray([ox, oy], np.float32)
            det_lm = np.asarray(out["landmarks"][j, k], np.float32).reshape(5, 2)
            lm_err.append(np.linalg.norm(det_lm - gt640, axis=1).mean())
    same, diff = pair_distances(np.asarray(embs_a), np.asarray(labs_a, np.int64))
    path_a = threshold_metrics(same, diff)

    # ---- paths C and B: GT-landmark warps on the host at serving vs native
    # resolution
    crops_c, crops_b = [], []
    for bgr, lm in zip(scenes, gt_lms):
        # C: letterbox to det-640 exactly like the host producer, then warp
        img640, s, (ox, oy) = letterbox(bgr, det, to_rgb=True)
        lm640 = lm * s + np.asarray([ox, oy], np.float32)
        m = similarity_np(lm640, tmpl)
        crops_c.append(cv2.warpAffine(img640, m, (112, 112),
                                      flags=cv2.INTER_LINEAR))
        # B: warp straight from the native 1080p frame (RGB)
        rgb_full = np.ascontiguousarray(bgr[..., ::-1])
        m2 = similarity_np(lm, tmpl)
        crops_b.append(cv2.warpAffine(rgb_full, m2, (112, 112),
                                      flags=cv2.INTER_LINEAR))
    ec = embed_crops(np.stack(crops_c).astype(np.float32), arch=args.arch, device=device)
    eb = embed_crops(np.stack(crops_b).astype(np.float32), arch=args.arch, device=device)
    path_c = threshold_metrics(*pair_distances(ec, labels))
    path_b = threshold_metrics(*pair_distances(eb, labels))

    report = {
        "arch": args.arch,
        "tier": args.tier,
        "backend": backend_name(device),
        "scenes": len(scenes),
        "detected": len(labs_a),
        "landmark_err_det640_px": {
            "mean": round(float(np.mean(lm_err)), 2),
            "median": round(float(np.median(lm_err)), 2),
            "p90": round(float(np.percentile(lm_err, 90)), 2),
        },
        "path_a_engine_e2e": path_a,
        "path_c_gt_landmarks_det640": path_c,
        "path_b_gt_landmarks_native": path_b,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    print(f"\nwrote {args.out}")
    print(
        f"\nTPR@0.6  A(engine)={path_a['tpr@0.6']:.3f}  "
        f"C(GT@640)={path_c['tpr@0.6']:.3f}  "
        f"B(GT@native)={path_b['tpr@0.6']:.3f}   "
        f"lm err mean {report['landmark_err_det640_px']['mean']} px"
    )
    print(f"{time.perf_counter() - t0:.1f} s wall")
    return report


if __name__ == "__main__":
    main()
