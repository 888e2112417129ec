"""Bootstrap-pretrain the RetinaFace detector on synthetic face scenes and
save the weights the engine loads (weights/retinaface_synthetic.npz). Port of
``tools/pretrain_synthetic.py``.

Usage: python -m frp_tpu_torch.tools.pretrain_synthetic [--steps 400] [--det-size 320]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--det-size", type=int, default=320)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--out", default="weights/retinaface_synthetic.npz")
    p.add_argument("--resume", default=None,
                   help="fine-tune from an existing .npz instead of scratch")
    p.add_argument("--portrait-frac", type=float, default=0.0,
                   help="fraction of scenes forced to the single-face closeup enrol shape")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from frp_tpu_torch.models.params import convert_params, flatten_params, load_params, save_params
    from frp_tpu_torch.train.detector import DetectorTrainer
    from frp_tpu_torch.train.synthetic import make_batch

    trainer = DetectorTrainer(det_size=args.det_size, seed=0, learning_rate=args.lr,
                              device=args.device)
    if args.resume:
        warm = flatten_params(convert_params(load_params(args.resume)))
        with torch.no_grad():
            for k, p_ in flatten_params(trainer.state["params"]).items():
                p_.copy_(warm[k])
        print(f"resumed params from {args.resume}")
    rng = np.random.default_rng(0)
    t0 = time.time()
    for step in range(args.steps):
        # "mix" spans the widened domain (pose, occlusion, light, blur tiers)
        images, boxes, ldms, valid = make_batch(args.batch, args.det_size, rng, difficulty="mix",
                                                portrait_frac=args.portrait_frac)
        m = trainer.train_step(images, boxes, ldms, valid)
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {m['step']:4d}  loss {m['loss']:.3f}  cls {m['cls_loss']:.3f} "
                  f"loc {m['loc_loss']:.3f}  ldm {m['ldm_loss']:.3f}  "
                  f"({(time.time() - t0) / (step + 1):.2f}s/step)", flush=True)
    save_params(args.out, trainer.detector_params())
    print(f"saved {args.out}")
    return {"history": trainer.history, "trainer": trainer}


if __name__ == "__main__":
    main()
