"""Federated-learning client: train locally with ArcFace, upload the weight
delta over the platform's HTTP contract, optionally trigger aggregation.
Port of ``tools/fl_client.py``. Run one per site:

    python -m frp_tpu_torch.tools.fl_client --url http://server:8000 \\
        --client-id site_a --steps 50 --identities 16 [--aggregate]

Without ``--seed`` the data seed is ``abs(hash(client_id))``, which Python
salts per process unless PYTHONHASHSEED is set (as the JAX tool does); pass
``--seed`` for a run that repeats.
"""

from __future__ import annotations

import argparse
import json
import urllib.request

import numpy as np


def post_json(url: str, payload: dict) -> dict:
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--url", default="http://localhost:8000")
    p.add_argument("--client-id", required=True)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--identities", type=int, default=16)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=None,
                   help="data seed (defaults to a hash of client-id: each site sees "
                        "different identities)")
    p.add_argument("--aggregate", action="store_true",
                   help="request FedAvg aggregation after uploading")
    p.add_argument("--max-layers", type=int, default=0,
                   help="upload only the first N layers (0 = all)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from frp_tpu_torch.train.arcface import ArcFaceTrainer
    from frp_tpu_torch.train.synthetic import make_identity, make_identity_crop

    seed = args.seed if args.seed is not None else abs(hash(args.client_id)) % 2**31
    rng = np.random.default_rng(seed)
    identities = [make_identity(int(rng.integers(0, 2**31))) for _ in range(args.identities)]

    trainer = ArcFaceTrainer(num_classes=args.identities, seed=0, learning_rate=args.lr,
                             device=args.device)
    for step in range(args.steps):
        labels = rng.integers(0, args.identities, size=(args.batch,)).astype(np.int32)
        crops = np.stack([make_identity_crop(identities[l], rng) for l in labels])
        m = trainer.train_step((crops.astype(np.float32) - 127.5) / 128.0, labels)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"[{args.client_id}] step {m['step']} loss {m['loss']:.3f} "
                  f"acc {m['accuracy']:.3f}", flush=True)

    delta = trainer.weights_delta()
    if args.max_layers:
        delta = {k: delta[k] for k in sorted(delta)[: args.max_layers]}
    payload = {
        "client_id": args.client_id,
        "weights": {k: np.asarray(v).tolist() for k, v in delta.items()},
    }
    result = post_json(args.url.rstrip("/") + "/face/fl/upload_weights", payload)
    print(f"[{args.client_id}] uploaded {result.get('total_params')} params, "
          f"round {result.get('round')}")
    out = {"delta": delta, "upload": result, "history": trainer.history}
    if args.aggregate:
        agg = post_json(args.url.rstrip("/") + "/face/fl/aggregate", {})
        print(f"aggregated: version {agg.get('version')} from {agg.get('clients')}")
        out["aggregate"] = agg
    return out


if __name__ == "__main__":
    main()
