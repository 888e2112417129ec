"""Prototype: test-time flip averaging on the e2e serving path. Port of
``tools/prototype_flip_tta.py``: the same scenes, engine path, metrics and
file fields, on the port's engine.

Hypothesis: synthetic identities are bilaterally symmetric
(train/synthetic.py make_identity: eye spacing and mouth are centred), so a
horizontally mirrored face is the SAME identity at mirrored yaw. Averaging
the embedding of a scene with the embedding of its mirrored scene should
denoise pose, the nuisance that dominates the tier-2 e2e gap.

Measures, per tier, on the SAME scenes (only those detected in both
orientations): baseline against flip-averaged TPR@0.6 / FPR@0.6 / AUC.
Each scene goes through the engine (kernels 1 and 2 on the card) in both
orientations; the flip is done by hand on the scenes, not by the engine's
flip-TTA mode. Purely diagnostic: changes no serving code.

Usage: python -m frp_tpu_torch.tools.prototype_flip_tta [--arch iresnet18]
           [--identities 20] [--variants 4] [--out PATH] [--device cuda|cpu]
Writes build/frp_tpu_torch/flip_tta_profile.json unless --out names a file.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from frp_tpu_torch.ops.cuda_build import BUILD_DIR

SEED = 9300  # match tiered_eval's held-out range
DEFAULT_OUT = os.path.join(BUILD_DIR, "flip_tta_profile.json")


def embed_indexed(engine, scenes):
    """Like train.pairs.embed_scenes but returns {scene_idx: unit_embedding}
    so the two orientations can be joined per scene."""
    from frp_tpu_torch.engine.batching import build_batch_i420

    out_map = {}
    bsz = 8
    for i in range(0, len(scenes), bsz):
        chunk = scenes[i : i + bsz]
        batch, _meta = build_batch_i420(
            {j: f for j, f in enumerate(chunk)}, engine.cfg.det_size, slots=bsz
        )
        out = engine.process_frames(batch, fmt="yuv420")
        for j in range(len(chunk)):
            valid = out["valid"][j]
            if not valid.any():
                continue
            k = int(np.argmax(np.where(valid, out["scores"][j], -1.0)))
            emb = out["embeddings"][j, k] / engine.distance_scale  # unit
            out_map[i + j] = np.asarray(emb, np.float64)
    return out_map


def metrics(embs, labels, scale):
    from frp_tpu_torch.train.pairs import pair_distances, threshold_metrics

    e = np.asarray(embs, np.float64)
    e = e / np.linalg.norm(e, axis=1, keepdims=True) * scale
    same, diff = pair_distances(e, np.asarray(labels, np.int64))
    return threshold_metrics(same, diff)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="iresnet18")
    p.add_argument("--identities", type=int, default=20)
    p.add_argument("--variants", type=int, default=4)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    t0 = time.perf_counter()

    from frp_tpu_torch.config import load_config
    from frp_tpu_torch.engine.pipeline import RecognitionEngine, resolve_device
    from frp_tpu_torch.train.pairs import build_scene_set

    eng = RecognitionEngine(load_config(
        det_size=640, max_faces_per_frame=16, embedder_arch=args.arch,
    ), device=resolve_device(args.device))
    scale = float(eng.distance_scale)
    result = {"arch": args.arch, "identities": args.identities,
              "variants": args.variants, "seed": SEED, "tiers": {}}
    for tier in (0, 1, 2, 3):
        scenes, labels = build_scene_set(
            args.identities, args.variants, SEED, difficulty=tier
        )
        base = embed_indexed(eng, scenes)
        flipped = embed_indexed(eng, [np.ascontiguousarray(s[:, ::-1])
                                      for s in scenes])
        common = sorted(set(base) & set(flipped))
        labs = [labels[i] for i in common]
        e_base = [base[i] for i in common]
        e_avg = [base[i] + flipped[i] for i in common]  # renormalized below
        row = {
            "scenes": len(scenes),
            "detected_base": len(base),
            "detected_flipped": len(flipped),
            "common": len(common),
            "baseline": metrics(e_base, labs, scale),
            "flip_avg": metrics(e_avg, labs, scale),
        }
        result["tiers"][str(tier)] = row
        b, f = row["baseline"], row["flip_avg"]
        print(f"tier {tier}: common={len(common)}/{len(scenes)}  "
              f"base tpr@0.6={b.get('tpr@0.6')} auc={b.get('auc')}  ->  "
              f"flip tpr@0.6={f.get('tpr@0.6')} auc={f.get('auc')}",
              flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(f"wrote {args.out}")
    print(f"{time.perf_counter() - t0:.1f} s wall")
    return result


if __name__ == "__main__":
    main()
