"""Held-out evaluation of the shipped spoof head. Port of
``tools/eval_spoof.py``: the same renders, legs, metrics and file fields, on
the port's models and engine.

Protocol: held-out identities (seeds 9600.., disjoint from the 0..31
training range and from every other eval seed), the generator family of
``tools/pretrain_spoof.py`` ("real" = rendered crops; "fake" = the same
crops with screen-replay artifacts at render scale, then the serving
resample). Three legs:

* crop/matched: the training artifact distribution (the easy bound);
* crop/attenuated: replay artifacts blended 50 % back toward the clean
  crop, weaker than anything trained on;
* e2e/frames: the full serving path on 1080p one-face scenes, fakes
  degraded at frame scale, through the engine's detect -> crop -> spoof.

The crop legs classify with ``<repo>/weights/spoof.npz``, as the JAX tool
does; the e2e leg with the engine's spoof candidate. Writes
weights/spoof_eval.json (relative to the repository root) with the spoof
weights' sha256.

Usage: python -m frp_tpu_torch.tools.eval_spoof [--identities 24]
           [--per-identity 8] [--e2e-scenes 48] [--out PATH] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

SEED = 9600  # disjoint: train 0..31, calib 9000, tiered 9300, parity 9500
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def roc_metrics(real_probs: np.ndarray, fake_probs: np.ndarray) -> dict:
    """Operating characteristics of fake_prob as a score (higher = fake)."""
    scores = np.concatenate([real_probs, fake_probs])
    labels = np.concatenate([np.zeros(len(real_probs)), np.ones(len(fake_probs))])
    order = np.argsort(-scores, kind="stable")
    labels_sorted = labels[order]
    tps = np.cumsum(labels_sorted)
    fps = np.cumsum(1 - labels_sorted)
    tpr = tps / max(tps[-1], 1)
    fpr = fps / max(fps[-1], 1)
    auc = float(np.trapezoid(tpr, fpr))
    # EER: threshold sweep over observed scores
    fnr = 1 - tpr
    i = int(np.argmin(np.abs(fnr - fpr)))
    eer = float((fnr[i] + fpr[i]) / 2)
    # TPR at the low-FPR operating point (1 % false alarms on real faces)
    j = int(np.searchsorted(fpr, 0.01, side="right")) - 1
    tpr_at_fpr1 = float(tpr[j]) if j >= 0 else 0.0
    thresh = 0.5  # the serving decision threshold
    return {
        "n_real": int(len(real_probs)),
        "n_fake": int(len(fake_probs)),
        "auc": round(auc, 4),
        "eer": round(eer, 4),
        "tpr@fpr1%": round(tpr_at_fpr1, 4),
        "accuracy@0.5": round(float(np.mean(np.concatenate([
            real_probs < thresh, fake_probs >= thresh]))), 4),
        "tpr@0.5": round(float(np.mean(fake_probs >= thresh)), 4),
        "fpr@0.5": round(float(np.mean(real_probs >= thresh)), 4),
        "real_prob_median": round(float(np.median(real_probs)), 4),
        "fake_prob_median": round(float(np.median(fake_probs)), 4),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--identities", type=int, default=24)
    p.add_argument("--per-identity", type=int, default=8)
    p.add_argument("--e2e-scenes", type=int, default=48)
    p.add_argument("--out", default="weights/spoof_eval.json")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    import cv2
    import torch

    from frp_tpu_torch.config import load_config
    from frp_tpu_torch.engine.batching import active_rows_for, build_batch_i420
    from frp_tpu_torch.engine.pipeline import RecognitionEngine, resolve_device
    from frp_tpu_torch.models.mobilenetv3 import mobilenetv3_forward
    from frp_tpu_torch.models.params import convert_params, load_params
    from frp_tpu_torch.ops.image import normalize_imagenet
    from frp_tpu_torch.tools.calibrate_embedder import backend_name
    from frp_tpu_torch.tools.pretrain_spoof import replay_artifacts, resample
    from frp_tpu_torch.train.synthetic import make_identity, make_identity_crop, render_face
    from frp_tpu_torch.utils.fingerprint import weights_fingerprint

    device = resolve_device(args.device)
    npz = os.path.join(REPO, "weights", "spoof.npz")
    params = convert_params(load_params(npz), device)

    def classify(crops: list[np.ndarray]) -> np.ndarray:
        out = []
        with torch.no_grad():
            for i in range(0, len(crops), 64):
                x = torch.from_numpy(np.stack(crops[i : i + 64]).astype(np.float32)).to(device)
                logits = mobilenetv3_forward(params, normalize_imagenet(x).to(torch.bfloat16))
                out.append(torch.softmax(logits, dim=-1)[:, 1])
            return torch.cat(out).cpu().numpy()

    identities = [make_identity(SEED + s) for s in range(args.identities)]
    rng = np.random.default_rng(SEED)

    def gen_crops(attenuate: float | None):
        """(real, fake) crop lists; attenuate in (0, 1] blends the degraded
        fake back toward the clean crop (weaker artifacts than trained on)."""
        real, fake = [], []
        for ident in identities:
            for _ in range(args.per_identity):
                render = int(112 * rng.uniform(1.0, 2.0))
                clean = make_identity_crop(ident, rng, size=render)
                deg = replay_artifacts(clean, rng)
                if attenuate is not None:
                    deg = np.clip(clean.astype(np.float32) * (1 - attenuate)
                                  + deg.astype(np.float32) * attenuate, 0, 255).astype(np.uint8)
                for crop, sink in ((clean, real), (deg, fake)):
                    if render != 112:
                        crop = cv2.resize(crop, (112, 112), interpolation=cv2.INTER_AREA)
                    sink.append(resample(crop, rng))
        return real, fake

    print("crop/matched …", flush=True)
    real, fake = gen_crops(attenuate=None)
    matched = roc_metrics(classify(real), classify(fake))
    print(json.dumps(matched))

    print("crop/attenuated (50% artifact strength) …", flush=True)
    real_a, fake_a = gen_crops(attenuate=0.5)
    attenuated = roc_metrics(classify(real_a), classify(fake_a))
    print(json.dumps(attenuated))

    # e2e: 1080p scenes, fakes degraded at frame scale, then the serving
    # letterbox + detect + align resample to the head
    print("e2e/frames …", flush=True)
    eng = RecognitionEngine(load_config(det_size=640, max_faces_per_frame=4, frames_per_batch=8),
                            device=device)
    probs: dict = {0: [], 1: []}
    scenes, labels = [], []
    for k in range(args.e2e_scenes):
        frame = rng.integers(20, 110, size=(1080, 1920, 3), dtype=np.uint8)
        render_face(frame, float(rng.uniform(500, 1400)), float(rng.uniform(350, 730)),
                    float(rng.uniform(180, 300)), rng, identity=identities[k % len(identities)])
        is_fake = k % 2
        if is_fake:
            frame = replay_artifacts(frame, rng)
        scenes.append(np.ascontiguousarray(frame[..., ::-1]))  # BGR, as cameras
        labels.append(is_fake)
    for i in range(0, len(scenes), 8):
        # the serving ingest: host letterbox to the det grid + I420 active rows
        cams = {j: f for j, f in enumerate(scenes[i : i + 8])}
        rows = active_rows_for([f.shape[:2] for f in cams.values()], 640)
        batch, _ = build_batch_i420(cams, 640, active_rows=rows)
        res = eng.fetch(eng.submit(batch, fmt="yuv420"))
        for b in range(batch.shape[0]):
            for m in range(res["valid"].shape[1]):
                if res["valid"][b, m]:
                    probs[labels[i + b]].append(float(res["fake_prob"][b, m]))
    e2e = roc_metrics(np.asarray(probs[0]), np.asarray(probs[1]))
    print(json.dumps(e2e))

    easy = matched["auc"] >= 0.995
    out = {
        "seed": SEED,
        "weights_file": "spoof.npz",
        "weights_sha256": weights_fingerprint(npz),
        "backend": backend_name(device),
        "fake_index": 1,
        "threshold": 0.5,
        "crop_matched": matched,
        "crop_attenuated_50pct": attenuated,
        "e2e_frames": e2e,
        "domain": "synthetic screen-replay artifacts (pretrain_spoof.py) on "
                  "held-out procedural identities; NOT real-world replay/"
                  "deepfake footage — no such data exists in this "
                  "environment",
        "caveat": (
            "matched-domain AUC is near-saturated: the synthetic replay "
            "domain is easy for a model trained on it; the attenuated and "
            "e2e rows are the informative ones"
            if easy else
            "matched-domain AUC is not saturated; the synthetic domain "
            "retains headroom"
        ),
    }
    path = os.path.join(REPO, args.out)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
