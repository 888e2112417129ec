"""Labeled same/different-identity pair fixtures + threshold-transfer metrics
(port of ``frp_tpu/train/pairs.py``: the same renders, the same metrics;
``embed_crops`` and ``embed_scenes`` run the port's embedder and engine, on
the card unless given another device).

The reference's match semantics (``backend/app/services/face_service.py:
395-443,486-506``) are euclidean distance over embeddings with an accept
threshold of 0.6 and confidence bands <0.4 high / <0.6 medium. dlib (the
reference's embedder) cannot run in this image, so decision parity is
validated as THRESHOLD TRANSFER: on a labeled pair set the shipped embedder
must put same-identity pairs under the accept threshold and
different-identity pairs over it, so code written against the reference's
0.4/0.6 constants behaves identically. Identities here are held-out
procedural renders (seeds disjoint from the training range in
tools/pretrain_embedder.py); production deployments re-run the same harness
on their real enrollment data (tools/parity_report.py).
"""

from __future__ import annotations

import numpy as np


def build_pair_crops(
    n_identities: int = 24,
    variants: int = 4,
    seed: int = 9000,
    size: int = 112,
    difficulty=None,
):
    """Render `variants` crops for each of `n_identities` held-out identities.

    Returns (crops [N*V, size, size, 3] float32 RGB, labels [N*V] int).
    Identity seeds start at `seed` — keep this >= 1000 so they are disjoint
    from the 0..63 range the shipped embedder trained on. ``difficulty``
    (None | tier | "mix") selects the nuisance tier (synthetic.TIERS)."""
    from frp_tpu_torch.train.synthetic import make_identity, make_identity_crop

    rng = np.random.default_rng(seed)
    crops, labels = [], []
    for i in range(n_identities):
        ident = make_identity(seed + i)
        for _ in range(variants):
            crops.append(
                make_identity_crop(ident, rng, size=size, difficulty=difficulty)
            )
            labels.append(i)
    return np.stack(crops).astype(np.float32), np.asarray(labels, np.int64)


def embed_crops(
    crops: np.ndarray,
    params=None,
    batch: int = 64,
    apply_calibration: bool = True,
    arch: str = "mobilefacenet",
    flip: bool = False,
    device=None,
) -> np.ndarray:
    """Embed rendered crops with the shipped (or given) embedder params
    (``arch`` selects the family: mobilefacenet or an iresnet variant);
    ``params`` is a numpy tree in the JAX layouts (``load_params``,
    ``embedder_params()``) or the port's tensor tree.

    With ``apply_calibration`` (default) embeddings are multiplied by the
    engine's measured distance scale, putting distances in the reference's
    0.4/0.6 band geometry — the same transform the serving embed stage
    applies. Pass False to measure the raw scale (the calibration tool).
    ``flip`` applies the engine's flip-TTA transform (renormalized mean
    with the horizontal mirror). Runs on ``device``, the card unless
    named."""
    import torch

    from frp_tpu_torch.engine.pipeline import resolve_device
    from frp_tpu_torch.models.params import convert_params, flatten_params
    from frp_tpu_torch.train.arcface import backbone_family

    dev = resolve_device(device)
    _init, forward = backbone_family(arch)
    scale = 1.0
    if params is None:
        from frp_tpu_torch.config import load_config
        from frp_tpu_torch.engine.pipeline import RecognitionEngine

        eng = RecognitionEngine(load_config(
            det_size=128, max_faces_per_frame=4, embedder_arch=arch,
            embed_flip_tta=flip,  # mode-keyed scale (engine refuses a cross-mode one)
        ), device=dev)
        params = eng.params["embedder"]
        if apply_calibration:
            scale = eng.distance_scale
    elif not any(isinstance(v, torch.Tensor) for v in flatten_params(params).values()):
        params = convert_params(params, dev)

    def fwd(x):
        e = forward(params, x)
        if not flip:
            return e
        # flip-TTA (engine EMBED_FLIP_TTA): renormalized mean with the mirror
        s_ = e + forward(params, x.flip(2))
        return s_ / torch.clamp(torch.linalg.vector_norm(s_, dim=-1, keepdim=True), min=1e-12)

    outs = []
    with torch.no_grad():
        for i in range(0, len(crops), batch):
            x = (crops[i : i + batch].astype(np.float32) - 127.5) / 128.0
            outs.append(fwd(torch.from_numpy(x).to(dev)))
        got = torch.cat(outs).cpu().numpy()  # one fetch
    return got * scale


def jitter_crop(crop: np.ndarray, rng) -> np.ndarray:
    """Simulate the serving path's alignment + resampling noise on a clean
    112-crop: random similarity transform (the detector's landmark error
    propagated through the Umeyama warp) + down/up resampling (faces are
    ~56-90 px on the 640 letterbox grid before the 112 warp). Used both for
    embedder training augmentation (tools/pretrain_embedder.py) and the
    jittered-pair parity check (tests/test_parity.py)."""
    try:
        import cv2
    except ImportError:
        return crop
    size = crop.shape[0]
    ang = float(rng.uniform(-10, 10))
    s = float(rng.uniform(0.92, 1.08))
    tx, ty = rng.uniform(-5, 5, size=2)
    m = cv2.getRotationMatrix2D((size / 2, size / 2), ang, s)
    m[:, 2] += (tx, ty)
    out = cv2.warpAffine(
        crop.astype(np.float32), m, (size, size), flags=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_REFLECT,
    )
    low = int(rng.integers(56, size + 1))
    if low < size:
        out = cv2.resize(
            cv2.resize(out, (low, low), interpolation=cv2.INTER_AREA),
            (size, size), interpolation=cv2.INTER_LINEAR,
        )
    return out


def build_scene_set(
    n_identities: int = 24,
    variants: int = 3,
    seed: int = 9000,
    hw: tuple = (1080, 1920),
    difficulty=None,
):
    """Render one-face 1080p scenes per identity — the END-TO-END fixture:
    distances measured through detect -> landmark alignment -> warp -> embed
    include the detector's localization noise, exactly like the serving path
    (the reference's decisions are end-to-end too, camera.py:232-256).
    ``difficulty`` (None | tier | "mix") applies the nuisance tier to the
    scene (pose/occlusion on the face, photometric on the frame)."""
    from frp_tpu_torch.train.synthetic import (
        TIERS,
        _pick_tier,
        apply_photometric,
        make_identity,
        render_face,
        sample_pose,
    )

    rng = np.random.default_rng(seed)
    h, w = hw
    scenes, labels = [], []
    for i in range(n_identities):
        ident = make_identity(seed + i)
        for _ in range(variants):
            rgb = rng.integers(20, 110, size=(h, w, 3), dtype=np.uint8)
            tier = _pick_tier(rng, difficulty)
            kw = {}
            if tier is not None:
                occ = TIERS[tier]["occ"]
                kw = dict(
                    pose=sample_pose(rng, tier),
                    occlusion=occ if (occ and rng.random() < 0.5) else 0.0,
                )
            render_face(
                rgb,
                w / 2 + float(rng.uniform(-w / 8, w / 8)),
                h / 2 + float(rng.uniform(-h / 8, h / 8)),
                float(rng.uniform(170, 240)),
                rng,
                identity=ident,
                **kw,
            )
            if tier is not None:
                rgb = apply_photometric(rgb, rng, tier)
            scenes.append(np.ascontiguousarray(rgb[..., ::-1]))  # BGR
            labels.append(i)
    return scenes, np.asarray(labels, np.int64)


def embed_scenes(engine, scenes, labels, apply_calibration: bool = True):
    """Run scenes through the full engine; return (embeddings, labels) for
    scenes where exactly the rendered face was detected (best-scoring slot).
    With apply_calibration=False the engine's distance scale is divided back
    out (raw geometry, for the calibration tool)."""
    from frp_tpu_torch.engine.batching import build_batch_i420

    embs, out_labels = [], []
    bsz = 8
    for i in range(0, len(scenes), bsz):
        chunk = scenes[i : i + bsz]
        batch, meta = build_batch_i420(
            {j: f for j, f in enumerate(chunk)}, engine.cfg.det_size, slots=bsz
        )
        out = engine.process_frames(batch, fmt="yuv420")
        for j in range(len(chunk)):
            valid = out["valid"][j]
            if not valid.any():
                continue
            k = int(np.argmax(np.where(valid, out["scores"][j], -1.0)))
            emb = out["embeddings"][j, k]
            if not apply_calibration:
                emb = emb / engine.distance_scale
            embs.append(emb)
            out_labels.append(labels[i + j])
    return np.asarray(embs), np.asarray(out_labels, np.int64)


def pair_distances(embeddings: np.ndarray, labels: np.ndarray):
    """All-pairs euclidean distances split by label agreement.

    Returns (same_distances, diff_distances) as 1-d arrays."""
    d2 = (
        np.sum(embeddings**2, axis=1)[:, None]
        + np.sum(embeddings**2, axis=1)[None, :]
        - 2.0 * embeddings @ embeddings.T
    )
    dist = np.sqrt(np.maximum(d2, 0.0))
    iu = np.triu_indices(len(labels), k=1)
    same_mask = labels[iu[0]] == labels[iu[1]]
    return dist[iu][same_mask], dist[iu][~same_mask]


def eer_sweep(same: np.ndarray, diff: np.ndarray, points: int = 801):
    """(tau, eer): threshold sweep over [0, 2] where FNR==FPR — the one
    implementation shared by threshold_metrics and the calibration tool
    (tools/calibrate_embedder.py derives distance_scale from tau)."""
    ts = np.linspace(0, 2, points)
    fnr = np.array([np.mean(same > t) for t in ts])
    fpr = np.array([np.mean(diff <= t) for t in ts])
    i = int(np.argmin(np.abs(fnr - fpr)))
    return float(ts[i]), float((fnr[i] + fpr[i]) / 2)


def threshold_metrics(same: np.ndarray, diff: np.ndarray, thresholds=(0.4, 0.6)):
    """TPR/FPR at the reference thresholds + AUC + EER for the pair set."""
    if len(same) == 0 or len(diff) == 0:
        raise ValueError(
            f"need both pair populations (same={len(same)}, diff={len(diff)}): "
            "the detector found too few faces/identities to form pairs"
        )
    out = {"n_same": int(len(same)), "n_diff": int(len(diff))}
    for t in thresholds:
        out[f"tpr@{t}"] = float(np.mean(same <= t))
        out[f"fpr@{t}"] = float(np.mean(diff <= t))
    # AUC via rank statistic (probability a same-pair scores closer)
    allscores = np.concatenate([same, diff])
    order = np.argsort(allscores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(allscores) + 1)
    r_same = ranks[: len(same)].sum()
    auc = 1.0 - (r_same - len(same) * (len(same) + 1) / 2) / (len(same) * len(diff))
    out["auc"] = float(auc)
    # EER: shared sweep (same resolution as the calibration tool)
    _tau, eer = eer_sweep(same, diff)
    out["eer"] = eer
    out["same_median"] = float(np.median(same))
    out["diff_median"] = float(np.median(diff))
    return out
