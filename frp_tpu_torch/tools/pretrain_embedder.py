"""Bootstrap-pretrain an embedder with ArcFace on synthetic identities;
saves weights/{arch}.npz (the file the engine loads for that
cfg.embedder_arch). Port of ``tools/pretrain_embedder.py``.

Usage: python -m frp_tpu_torch.tools.pretrain_embedder [--steps 300] [--identities 64]
       python -m frp_tpu_torch.tools.pretrain_embedder --arch iresnet18 --steps 600
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--identities", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--arch", default="mobilefacenet",
                   help="mobilefacenet | iresnet18/34/50/100")
    p.add_argument("--out", default=None, help="default: weights/{arch}.npz")
    p.add_argument("--resume", default=None,
                   help="warm-start the backbone from this .npz before training")
    p.add_argument("--save-every", type=int, default=0,
                   help="also save --out every N steps (a killed process keeps its progress)")
    p.add_argument("--difficulty", default="mix",
                   help='tier sampling for training crops: "mix" (TIER_MIX), a tier int, or '
                        'a comma list of per-tier probabilities ("0.15,0.25,0.45,0.15")')
    p.add_argument("--serving-frac", type=float, default=0.0,
                   help="fraction of training crops drawn from the serving-matched "
                        "distribution (synthetic.make_serving_crop) instead of 112 renders")
    p.add_argument("--margin", type=float, default=0.5)
    p.add_argument("--margin-warmup", type=int, default=0,
                   help="ramp the ArcFace margin linearly 0 -> --margin over N steps "
                        "(deep backbones diverge if the full margin lands on random embeddings)")
    p.add_argument("--state", default=None,
                   help="full trainer-state checkpoint path (params, classifier, optimizer, "
                        "step; train/checkpoint.py), saved at --save-every and at the end and "
                        "restored at startup when present; unlike --resume it keeps the "
                        "ArcFace classifier")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    if args.out is None:
        args.out = f"weights/{args.arch}.npz"
    difficulty = args.difficulty
    if "," in difficulty:
        difficulty = tuple(float(x) for x in difficulty.split(","))
    elif difficulty != "mix":
        difficulty = int(difficulty)
    args.difficulty = difficulty
    return args


def separation(forward, params, identities, rng, device, k: int = 16) -> dict:
    """Mean same-identity and cross-identity distance over 4 fresh crops of
    each of the first k identities."""
    from frp_tpu_torch.train.synthetic import make_identity_crop

    k = min(k, len(identities))
    embs = []
    with torch.no_grad():
        for ident in identities[:k]:
            crops = np.stack([make_identity_crop(ident, rng) for _ in range(4)])
            x = torch.from_numpy((crops.astype(np.float32) - 127.5) / 128.0).to(device)
            embs.append(forward(params, x).cpu().numpy())
    embs = np.stack(embs)  # [k, 4, D]
    same = [np.linalg.norm(e[i] - e[j]) for e in embs for i in range(4) for j in range(i + 1, 4)]
    cross = [np.linalg.norm(embs[a, 0] - embs[b, 0]) for a in range(k) for b in range(a + 1, k)]
    return {"same": float(np.mean(same)), "cross": float(np.mean(cross))}


def main(argv=None) -> dict:
    args = parse_args(argv)

    from frp_tpu_torch.models.params import convert_params, flatten_params, load_params, save_params
    from frp_tpu_torch.train.arcface import ArcFaceTrainer, backbone_family
    from frp_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from frp_tpu_torch.train.pairs import jitter_crop
    from frp_tpu_torch.train.synthetic import make_identity, make_identity_crop, make_serving_crop

    identities = [make_identity(s) for s in range(args.identities)]
    trainer = ArcFaceTrainer(num_classes=args.identities, seed=0, learning_rate=args.lr,
                             arch=args.arch, margin=args.margin, device=args.device)
    resumed_step = 0
    if args.resume:
        warm = flatten_params(convert_params(load_params(args.resume)))
        with torch.no_grad():
            for k, p in flatten_params(trainer.state["params"]["backbone"]).items():
                p.copy_(warm[k])
        print(f"resumed backbone from {args.resume}")
    if args.state and load_checkpoint(args.state, like=trainer.state) is not None:
        resumed_step = trainer.state["step"]
        print(f"restored full trainer state from {args.state} (step {resumed_step})")

    rng = np.random.default_rng(0)

    def sample_crop(label):
        if args.serving_frac and rng.random() < args.serving_frac:
            return make_serving_crop(identities[label], rng, difficulty=args.difficulty)
        # alignment jitter and resampling: the serving path embeds detector-
        # aligned warps of 56-90 px faces, not pristine renders
        return jitter_crop(make_identity_crop(identities[label], rng, difficulty=args.difficulty), rng)

    t0 = time.time()
    for step in range(args.steps):
        labels = rng.integers(0, args.identities, size=(args.batch,)).astype(np.int32)
        crops = np.stack([sample_crop(l) for l in labels]).astype(np.float32)
        eff_step = resumed_step + step  # warmup counts from the restored step
        m_t = (args.margin if not args.margin_warmup
               else args.margin * min(1.0, eff_step / args.margin_warmup))
        m = trainer.train_step((crops - 127.5) / 128.0, labels, margin=m_t)
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {m['step']:4d}  loss {m['loss']:.3f}  acc {m['accuracy']:.3f} "
                  f"({(time.time() - t0) / (step + 1):.2f}s/step)", flush=True)
        if args.save_every and step and step % args.save_every == 0:
            save_params(args.out, trainer.embedder_params())
            if args.state:
                save_checkpoint(args.state, trainer.state)
            print(f"checkpointed {args.out} at step {step}", flush=True)
    save_params(args.out, trainer.embedder_params())
    if args.state:
        save_checkpoint(args.state, trainer.state)
        print(f"saved trainer state to {args.state}")
    print(f"saved {args.out}")

    _init, forward = backbone_family(args.arch)
    sep = separation(forward, trainer.state["params"]["backbone"], identities, rng, trainer.device)
    print(f"same-identity distance: mean {sep['same']:.3f}  cross-identity: mean "
          f"{sep['cross']:.3f}  (accept threshold 0.6)")
    return {"history": trainer.history, "separation": sep, "trainer": trainer}


if __name__ == "__main__":
    main()
