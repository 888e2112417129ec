"""Difficulty-tiered detector recall and threshold-transfer ROC. Port of
``tools/tiered_eval.py``: the same renders, engine path, metrics and file
fields, on the port's engine.

For each nuisance tier of the widened synthetic domain (0 near-frontal and
clean, 1 moderate, 2 hard: yaw to +-60 deg, 30 % occlusion, backlight,
motion blur; 3 tier-1 pose with JPEG and noise):

* detector recall on one-face 1080p scenes through the full serving path;
* end-to-end ROC (detect -> align -> warp -> embed distances) at the
  reference's 0.4/0.6 decision constants;
* crop-level ROC on aligned 112 crops with alignment jitter.

Writes weights/tiered_eval.json (MobileFaceNet) or
weights/tiered_eval_{arch}[_flip].json and prints the markdown table.
Identities are held out from the training range (seeds >= 9000).

Usage: python -m frp_tpu_torch.tools.tiered_eval [--arch iresnet18] [--flip]
           [--out PATH] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

SEED = 9300  # disjoint from training (0..63), calibration (9000..), parity (9500..)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None,
                   help="default: weights/tiered_eval.json (mobilefacenet) "
                        "or weights/tiered_eval_{arch}.json")
    p.add_argument("--identities", type=int, default=20)
    p.add_argument("--variants", type=int, default=4)
    p.add_argument("--arch", default="mobilefacenet")
    p.add_argument("--flip", action="store_true",
                   help="evaluate the flip-TTA embedding mode (EMBED_FLIP_TTA; "
                        "requires the mode-keyed calibration_{arch}_flip.json)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    if args.out is None:
        suffix = "_flip" if args.flip else ""
        args.out = ("weights/tiered_eval%s.json" % suffix
                    if args.arch == "mobilefacenet" and not args.flip
                    else f"weights/tiered_eval_{args.arch}{suffix}.json")

    from frp_tpu_torch.config import load_config
    from frp_tpu_torch.engine.batching import _resize_interp
    from frp_tpu_torch.engine.pipeline import RecognitionEngine, resolve_device
    from frp_tpu_torch.tools.calibrate_embedder import backend_name
    from frp_tpu_torch.train.pairs import (
        build_pair_crops,
        build_scene_set,
        embed_crops,
        embed_scenes,
        jitter_crop,
        pair_distances,
        threshold_metrics,
    )
    from frp_tpu_torch.utils.fingerprint import weights_fingerprint

    device = resolve_device(args.device)
    eng = RecognitionEngine(load_config(
        det_size=640, max_faces_per_frame=16, embedder_arch=args.arch,
        embed_flip_tta=args.flip,
    ), device=device)
    rng = np.random.default_rng(SEED)
    emb_file = eng.weights_loaded.get("embedder")
    det_file = eng.weights_loaded.get("detector")
    out: dict = {"seed": SEED, "identities": args.identities,
                 "variants": args.variants, "arch": args.arch,
                 "flip_tta": bool(args.flip),
                 # provenance: the device's numerics, the decimation kernel
                 # and the exact weights
                 "backend": backend_name(device),
                 "resize_interp": _resize_interp(),
                 "weights_file": os.path.basename(emb_file) if emb_file else None,
                 "weights_sha256": weights_fingerprint(emb_file) if emb_file else None,
                 "detector_sha256": weights_fingerprint(det_file) if det_file else None,
                 "tiers": {}}
    for tier in (0, 1, 2, 3):
        scenes, slabels = build_scene_set(args.identities, args.variants, SEED, difficulty=tier)
        emb_e2e, lab_e2e = embed_scenes(eng, scenes, slabels)
        recall = len(lab_e2e) / len(slabels)
        tier_out: dict = {"detector_recall": round(recall, 4),
                          "scenes": len(slabels), "detected": len(lab_e2e)}
        # the e2e ROC needs enough detected identity pairs
        try:
            same, diff = pair_distances(emb_e2e, lab_e2e)
            tier_out["e2e"] = threshold_metrics(same, diff)
        except ValueError as e:
            tier_out["e2e"] = {"error": str(e)}
        crops, clabels = build_pair_crops(args.identities, args.variants, SEED, difficulty=tier)
        crops = np.stack([jitter_crop(c, rng) for c in crops])
        csame, cdiff = pair_distances(
            embed_crops(crops, arch=args.arch, flip=args.flip, device=device), clabels)
        tier_out["crop"] = threshold_metrics(csame, cdiff)
        out["tiers"][str(tier)] = tier_out
        print(f"tier {tier}: recall={recall:.3f} "
              f"e2e tpr@0.6={tier_out['e2e'].get('tpr@0.6')} "
              f"fpr@0.6={tier_out['e2e'].get('fpr@0.6')}", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\nwrote {args.out}\n")

    print("| Tier | Detector recall | e2e TPR@0.6 | e2e FPR@0.6 | "
          "e2e AUC | crop TPR@0.6 | crop FPR@0.6 |")
    print("|---|---|---|---|---|---|---|")
    names = {0: "0 easy (round-2 domain)", 1: "1 moderate", 2: "2 hard",
             3: "3 compressed (tier-1 pose + JPEG/noise)"}
    for tier in (0, 1, 2, 3):
        t = out["tiers"][str(tier)]
        e, c = t["e2e"], t["crop"]
        print(f"| {names[tier]} | {t['detector_recall']:.3f} | "
              f"{e.get('tpr@0.6', float('nan')):.3f} | "
              f"{e.get('fpr@0.6', float('nan')):.3f} | "
              f"{e.get('auc', float('nan')):.4f} | "
              f"{c['tpr@0.6']:.3f} | {c['fpr@0.6']:.3f} |")
    return out


if __name__ == "__main__":
    main()
