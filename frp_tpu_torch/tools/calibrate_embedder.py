"""Calibrate the embedder's distance scale to the reference's band geometry.
Port of ``tools/calibrate_embedder.py``: the same renders, engine path,
metrics and file fields, on the port's engine.

The reference's decision constants (0.6 accept / 0.4 high-confidence /
<0.3 duplicate) assume dlib's distance distribution. This tool measures the
embedder's own scale on a labelled pair set of held-out procedural
identities, end to end (detect -> landmark align -> warp -> embed, the
serving path), and derives ONE multiplicative constant s such that the raw
distance where the false-accept rate is 1 % lands at 0.6. The engine
multiplies embeddings by s at the embed stage.

Writes weights/calibration.json (MobileFaceNet) or
weights/calibration_{arch}[_flip].json with the fields of the JAX tool;
``backend`` names the torch device type and, on the card, its name.

Usage: python -m frp_tpu_torch.tools.calibrate_embedder [--arch iresnet18]
           [--flip] [--out PATH] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

CALIB_SEED = 9000  # calibration identities; tests use a DISJOINT range


def backend_name(device) -> str:
    """The torch device type, with the card's name on the card."""
    import torch

    if device.type == "cuda":
        return f"cuda ({torch.cuda.get_device_name(device)})"
    return device.type


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None,
                   help="default: weights/calibration.json (mobilefacenet) "
                        "or weights/calibration_{arch}.json")
    p.add_argument("--identities", type=int, default=24)
    p.add_argument("--variants", type=int, default=6)
    p.add_argument("--arch", default="mobilefacenet",
                   help="embedder family to calibrate (the engine loads the "
                        "arch-keyed calibration file for it)")
    p.add_argument("--flip", action="store_true",
                   help="calibrate the flip-TTA embedding mode (EMBED_FLIP_TTA); "
                        "writes the mode-keyed calibration_{arch}_flip.json")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    if args.out is None:
        suffix = "_flip" if args.flip else ""
        args.out = ("weights/calibration%s.json" % suffix
                    if args.arch == "mobilefacenet" and not args.flip
                    else f"weights/calibration_{args.arch}{suffix}.json")

    from frp_tpu_torch.config import load_config
    from frp_tpu_torch.engine.batching import _resize_interp
    from frp_tpu_torch.engine.pipeline import RecognitionEngine, resolve_device
    from frp_tpu_torch.train.pairs import (
        build_pair_crops,
        build_scene_set,
        eer_sweep,
        embed_crops,
        embed_scenes,
        pair_distances,
        threshold_metrics,
    )
    from frp_tpu_torch.utils.fingerprint import weights_fingerprint

    device = resolve_device(args.device)
    # the tool measures RAW distances and exists to replace a stale scale,
    # so it builds an engine that serving would refuse to start
    eng = RecognitionEngine(load_config(
        det_size=640, max_faces_per_frame=16, embedder_arch=args.arch,
        embed_flip_tta=args.flip,
    ), device=device, allow_stale_calibration=True)
    # the widened "mix" domain: the traffic the platform serves
    scenes, slabels = build_scene_set(args.identities, args.variants, CALIB_SEED,
                                      difficulty="mix")
    emb_e2e, lab_e2e = embed_scenes(eng, scenes, slabels, apply_calibration=False)
    same, diff = pair_distances(emb_e2e, lab_e2e)
    # the reference's 0.6 accept threshold is a low-FPR operating point, so
    # the scale maps the raw distance of FPR = 1 % onto 0.6; EER is reported
    tau_eer, _eer = eer_sweep(same, diff)
    tau_fpr = float(np.quantile(diff, 0.01))
    scale = 0.6 / tau_fpr

    crops, clabels = build_pair_crops(args.identities, 4, CALIB_SEED, difficulty="mix")
    emb_crop = embed_crops(crops, apply_calibration=False, arch=args.arch,
                           flip=args.flip, device=device)
    csame, cdiff = pair_distances(emb_crop, clabels)

    # fingerprint the weights this scale was measured on: the engine refuses
    # a calibration whose sha256 differs from the loaded embedder file
    emb_file = eng.weights_loaded.get("embedder")
    det_file = eng.weights_loaded.get("detector")
    payload = {
        "distance_scale": round(scale, 6),
        "arch": args.arch,
        "flip_tta": bool(args.flip),
        "weights_file": os.path.basename(emb_file) if emb_file else None,
        "weights_sha256": weights_fingerprint(emb_file) if emb_file else None,
        "detector_sha256": weights_fingerprint(det_file) if det_file else None,
        # provenance: the numbers depend on the device's numerics and the
        # decimation kernel
        "backend": backend_name(device),
        "resize_interp": _resize_interp(),
        "fpr1_threshold_raw": round(tau_fpr, 4),
        "eer_threshold_raw": round(tau_eer, 4),
        "calib_seed": CALIB_SEED,
        "identities": args.identities,
        "variants": args.variants,
        "detected_scenes": f"{len(lab_e2e)}/{len(slabels)}",
        "metrics_e2e_raw": threshold_metrics(same, diff),
        "metrics_e2e_calibrated": threshold_metrics(same * scale, diff * scale),
        "metrics_crop_calibrated": threshold_metrics(csame * scale, cdiff * scale),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps(payload, indent=1))
    print(f"\nwrote {args.out}")
    return payload


if __name__ == "__main__":
    main()
