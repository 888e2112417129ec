"""Bootstrap-pretrain the MobileNetV3 spoof classifier on synthetic
real-vs-replay crops; saves weights/spoof.npz. Port of
``tools/pretrain_spoof.py``.

"Real" = directly rendered face crops. "Fake" = the same crops degraded with
screen-replay artifacts: pixel-grid moire, flattened dynamic range, bezel
border, slight color cast.

Usage: python -m frp_tpu_torch.tools.pretrain_spoof [--steps 200] [--batch 64]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def replay_artifacts(crop: np.ndarray, rng) -> np.ndarray:
    """Screen-replay degradation of a real crop."""
    img = crop.astype(np.float32)
    # flatten dynamic range + cast
    img = img * rng.uniform(0.55, 0.75) + rng.uniform(40, 80)
    cast = rng.uniform(0.9, 1.1, size=3)
    img = img * cast
    # pixel-grid moire
    h, w = img.shape[:2]
    period = rng.integers(3, 6)
    grid = (np.arange(h)[:, None] % period == 0) | (np.arange(w)[None, :] % period == 0)
    img[grid] *= rng.uniform(0.75, 0.9)
    # bezel border, only sometimes: pipeline face crops usually exclude it
    if rng.random() < 0.3:
        b = rng.integers(2, 6)
        img[:b] = img[-b:] = 15
        img[:, :b] = img[:, -b:] = 15
    return np.clip(img, 0, 255).astype(np.uint8)


def resample(crop: np.ndarray, rng) -> np.ndarray:
    """Random down-up resample, as the letterbox and align path does, so the
    classifier cannot rely on pixel-grid artifacts that resampling destroys."""
    try:
        import cv2
    except ImportError:
        return crop
    h, w = crop.shape[:2]
    s = float(rng.uniform(0.4, 1.0))
    small = cv2.resize(crop, (max(8, int(w * s)), max(8, int(h * s))),
                       interpolation=cv2.INTER_AREA)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)


def make_spoof_batch(identities: list, rng, batch: int):
    """(crops [B, 112, 112, 3] float32 0..255, labels [B] int32, 1 = fake):
    each crop rendered at 1-2x, replay artifacts applied at that scale for a
    fake, then brought to 112 and resampled."""
    import cv2

    from frp_tpu_torch.train.synthetic import make_identity_crop

    crops, labels = [], []
    for _ in range(batch):
        ident = identities[rng.integers(0, len(identities))]
        fake = rng.random() < 0.5
        render = int(112 * rng.uniform(1.0, 2.0))
        crop = make_identity_crop(ident, rng, size=render)
        if fake:
            crop = replay_artifacts(crop, rng)
        if render != 112:
            crop = cv2.resize(crop, (112, 112), interpolation=cv2.INTER_AREA)
        crops.append(resample(crop, rng))
        labels.append(1 if fake else 0)  # idx1 = fake (reference convention)
    return np.stack(crops).astype(np.float32), np.asarray(labels, np.int32)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--out", default="weights/spoof.npz")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from frp_tpu_torch.models.params import save_params
    from frp_tpu_torch.train.classifier import SpoofTrainer
    from frp_tpu_torch.train.synthetic import make_identity

    identities = [make_identity(s) for s in range(32)]
    trainer = SpoofTrainer(seed=0, learning_rate=1e-3, device=args.device)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for step in range(args.steps):
        m = trainer.train_step(*make_spoof_batch(identities, rng, args.batch))
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {m['step']:4d}  loss {m['loss']:.3f}  acc {m['accuracy']:.3f} "
                  f"({(time.time() - t0) / (step + 1):.2f}s/step)", flush=True)
    save_params(args.out, trainer.classifier_params())
    print(f"saved {args.out}")
    return {"history": trainer.history, "trainer": trainer}


if __name__ == "__main__":
    main()
