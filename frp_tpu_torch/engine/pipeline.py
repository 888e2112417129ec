"""The recognition pipeline on PyTorch (port of ``frp_tpu/engine/pipeline.py``,
throughput and accuracy profiles): frames -> detections -> aligned crops ->
embeddings (+ spoof) -> gallery matches, as chained stages whose
intermediates stay on the device. Two entry points: ``RecognitionEngine``
(the staged scan below) and ``build_pipeline`` (the same stages as one
function of (params, frames, gallery, gallery_valid, priors), whose head is
decode + ``nms_padded_batched``, so every call launches kernel 3).

    I420 payload (DeltaEncoder)    host
      └ delta_ingest: block scatter onto the resident batch, BT.601, pad
      └ detect: RetinaFace -> top-K -> fused head    (ops/detection_cuda.py, kernel 1)
      └ crop: 5-point similarity -> bilinear warp    (ops/align_cuda.py, kernel 2)
              + quality scores
      └ embed: MobileFaceNet, or iresnet (+ flip-TTA), x distance scale,
               MobileNetV3 spoof; valid slots compacted into a rung
      └ match_pack: gallery match, packed [B, M, 22]
    fetch: one device->host copy, unpacked on the host

``pre_nms_topk`` > 256, and every call of ``build_pipeline``, routes detect
through decode + ``nms_padded_batched``, whose greedy pass is kernel 3
(``ops/nms_cuda.py``). Everything is shape-static: M = max_faces slots per
frame with validity masks.

Not ported yet (ROADMAP): mesh sharding,
``build_pipeline``'s ``with_spoof=False``, ``with_quality=False``
and ``spoof_size``, and the engine's ``with_spoof=False``, which no caller
of the port sets.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from frp_tpu_torch.config import Config, get_config
from frp_tpu_torch.engine.batching import DeltaEncoder, DeltaPayload, letterbox
from frp_tpu_torch.engine.gallery import DeviceGallery
from frp_tpu_torch.models import nn
from frp_tpu_torch.models.iresnet import init_iresnet, iresnet_forward
from frp_tpu_torch.models.mobilefacenet import init_mobilefacenet, mobilefacenet_forward
from frp_tpu_torch.models.mobilenetv3 import init_mobilenetv3_small, mobilenetv3_forward
from frp_tpu_torch.models.params import (
    convert_params,
    import_onnx_graph,
    import_onnx_weights,
    load_onnx_graph,
    load_params,
    same_structure,
)
from frp_tpu_torch.models.retinaface import init_retinaface, retinaface_forward
from frp_tpu_torch.ops.align import (
    ARCFACE_TEMPLATE_112,
    similarity_transform,
    warp_crops_batched,
)
from frp_tpu_torch.ops.anchors import generate_anchors
from frp_tpu_torch.ops.decode import decode_boxes, decode_landmarks
from frp_tpu_torch.ops.detection_cuda import fused_detection_head
from frp_tpu_torch.ops.image import (
    normalize_face,
    normalize_imagenet,
    preprocess_frames,
    yuv420_to_rgb,
)
from frp_tpu_torch.ops.matching import gallery_match
from frp_tpu_torch.ops.nms import nms_padded_batched
from frp_tpu_torch.ops.quality import assess_quality_batch
from frp_tpu_torch.utils.fingerprint import weights_fingerprint
from frp_tpu_torch.utils.logger import get_logger

logger = get_logger("frp.engine")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device; no silent CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the engine runs on the card; pass "
            "device='cpu' to run it on the CPU"
        )
    return dev


def embed_compact_rungs(
    n: int, enabled: bool | None = None, rung_env: str | None = None
) -> list[int]:
    """Compact-batch sizes (ascending, all < n) for the embed stage's
    valid-slot compaction; [] disables. Three rungs cover the serving
    regimes: few faces (n/8), mixed (n/2) and a face-dense scene (13n/16).
    FRP_EMBED_RUNGS ("16,64,104" style) overrides them, FRP_EMBED_COMPACT=0
    disables compaction, and batches of n < 64 (enrolment, compare uploads)
    skip it. ``enabled`` and ``rung_env`` stand in for the two variables:
    ``build_stages`` reads them once when it builds the stages."""
    if enabled is None:
        enabled = os.getenv("FRP_EMBED_COMPACT", "1") != "0"
    if rung_env is None:
        rung_env = os.getenv("FRP_EMBED_RUNGS")
    if not enabled or n < 64:
        return []
    if rung_env:
        rungs = sorted({int(x) for x in rung_env.split(",") if x.strip()})
    else:
        rungs = sorted({max(8, n // 8), n // 2, (13 * n) // 16})
    return [k for k in rungs if 0 < k < n]


def build_stages(
    *,
    device,
    det_size: int = 640,
    max_faces: int = 16,
    pre_nms_topk: int = 256,
    conf_thresh: float = 0.5,
    nms_thresh: float = 0.4,
    iom_thresh: float = 0.5,
    top_k: int = 5,
    compute_dtype: str = "bfloat16",
    fused_head: bool = True,
    embedder_forward=mobilefacenet_forward,
    flip_tta: bool = False,
    compact: bool = True,
):
    """The pipeline as chained stage functions (the JAX package's
    ``build_stages`` with spoof and quality always on and 112 px spoof
    crops). Constants live on ``device`` once, so no stage copies host data
    to the card. The detect stage's head is the fused detection head
    (kernel 1), as the JAX stages' on a TPU; ``fused_head=False`` takes
    decode + ``nms_padded_batched`` (kernel 3), the head of the JAX
    ``build_pipeline``. ``embedder_forward`` is MobileFaceNet's or
    iresnet's forward; ``flip_tta`` adds a forward of the mirrored crops.
    The embed stage's compaction (``embed_compact_rungs``) reads
    FRP_EMBED_COMPACT and FRP_EMBED_RUNGS here, once; ``compact=False``
    leaves it out whatever they say (``build_pipeline``, as the JAX one)."""
    cdtype = getattr(torch, compute_dtype)
    template = torch.from_numpy(ARCFACE_TEMPLATE_112.copy()).to(device)
    ident = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], dtype=torch.float32, device=device)

    def detect_stage(params, frames, priors):
        b, h, w, _ = frames.shape
        if h == det_size and w == det_size:  # host already letterboxed
            x = ((frames.to(torch.float32) - 127.5) / 128.0).to(cdtype)
            scale = torch.ones((b, 2), dtype=torch.float32, device=frames.device)
        else:
            x, scale = preprocess_frames(frames, det_size, compute_dtype)
        det = retinaface_forward(params, x)
        head = dict(pre_topk=pre_nms_topk, max_out=max_faces, conf_thresh=conf_thresh,
                    iou_thresh=nms_thresh, iom_thresh=iom_thresh)
        if fused_head:
            dets = fused_detection_head(
                det["loc"], det["ldm"], det["score"], priors,
                image_size=float(det_size), **head)
        else:
            dets = nms_padded_batched(
                decode_boxes(det["loc"], priors, float(det_size)),
                det["score"],
                decode_landmarks(det["ldm"], priors, float(det_size)),
                **head)
        sxy = scale[:, None, :]
        m = dets["valid"].shape[1]
        boxes = dets["boxes"] * torch.cat([sxy, sxy], dim=-1)
        ldm = (dets["landmarks"].reshape(b, m, 5, 2) * sxy[:, :, None, :]).reshape(b, m, 10)
        return {
            "boxes": boxes,
            "scores": dets["scores"],
            "landmarks": ldm,
            "valid": dets["valid"],
            "count": dets["count"],
        }

    def crop_stage(frames, dets):
        b, h, w, _ = frames.shape
        m = dets["valid"].shape[1]
        mats = similarity_transform(dets["landmarks"].reshape(b, m, 5, 2), template)
        # padded slots have collapsed landmarks -> degenerate transforms;
        # the identity keeps their sample coordinates benign
        mats = torch.where(dets["valid"][..., None, None], mats, ident)
        crops = warp_crops_batched(frames, mats, out_size=112)  # [B, M, 112, 112, 3]
        q = assess_quality_batch(
            crops.reshape(b * m, 112, 112, 3),
            dets["boxes"].reshape(b * m, 4),
            (h, w),
            dets["valid"].reshape(-1),
        )
        return {
            "crops": crops,
            "quality": q["score"].reshape(b, m),
            "blur_score": q["blur_score"].reshape(b, m),
        }

    def embed_core(params, flat):
        """Embedder + spoof on a flat crop batch [K, 112, 112, 3] ->
        (embeddings [K, D] f32, fake_prob [K])."""
        emb_in = normalize_face(flat).to(cdtype)
        emb = embedder_forward(params["embedder"], emb_in)
        if flip_tta:
            # a second forward of the crops mirrored along W; the sum of the
            # two unit embeddings is renormalised by its norm (the JAX
            # formula, not l2_normalize's rsqrt). Spoof is not doubled
            s = emb + embedder_forward(params["embedder"], torch.flip(emb_in, dims=[2]))
            emb = s / torch.clamp(torch.linalg.vector_norm(s, dim=-1, keepdim=True), min=1e-12)
        logits = mobilenetv3_forward(params["spoof"], normalize_imagenet(flat).to(cdtype))
        return emb, torch.softmax(logits, dim=-1)[:, 1]

    compact_enabled = compact and os.getenv("FRP_EMBED_COMPACT", "1") != "0"
    compact_rung_env = os.getenv("FRP_EMBED_RUNGS")

    def embed_stage(params, crops, valid, scale=1.0):
        b, m = crops.shape[0], crops.shape[1]
        n = b * m
        flat = crops.reshape(n, 112, 112, 3)
        vflat = valid.reshape(-1)
        rungs = embed_compact_rungs(n, enabled=compact_enabled, rung_env=compact_rung_env)
        # valid-slot compaction: the valid crops, gathered first, run through
        # the nets in the smallest rung that holds them, and their results
        # are scattered back. The JAX package picks the rung on the device
        # (lax.switch); here the host reads the batch's count of valid slots
        # once and picks it. Past the largest rung the whole batch runs
        k = None
        if rungs:
            nv = int(vflat.sum())
            k = next((r for r in rungs if nv <= r), None)
        if k is None:
            emb, fake = embed_core(params, flat)
        else:
            take = torch.argsort((~vflat).to(torch.uint8), stable=True)[:k]
            emb_k, fake_k = embed_core(params, flat[take])
            emb = emb_k.new_zeros((n, emb_k.shape[-1])).index_copy_(0, take, emb_k)
            fake = fake_k.new_zeros((n,)).index_copy_(0, take, fake_k)
        # distance-scale calibration (weights/calibration*.json): scaling
        # the embeddings scales every euclidean distance downstream
        return {
            "embeddings_flat": torch.where(vflat[:, None], emb * scale, 0.0),
            "fake_prob": torch.where(valid, fake.reshape(b, m), 0.0),
        }

    def match_stage(emb_flat, valid, gallery, gallery_valid, tol):
        b, m = valid.shape
        match = gallery_match(emb_flat, gallery, gallery_valid, tolerance=tol, top_k=top_k)
        return {
            "embeddings": emb_flat.reshape(b, m, -1),
            "best_idx": match["best_idx"].reshape(b, m),
            "best_distance": torch.where(
                valid, match["best_distance"].reshape(b, m), float("inf")),
            "is_match": match["is_match"].reshape(b, m) & valid,
            "topk_idx": match["topk_idx"].reshape(b, m, -1),
            "topk_distance": match["topk_distance"].reshape(b, m, -1),
        }

    def delta_stage(prev_img, idx, blocks):
        """Block-sparse delta reconstruction: scatter the shipped K-byte
        blocks onto the resident I420 batch. Padded slots carry idx=-1 and
        are remapped PAST the end, onto a scratch block that is dropped: a
        raw -1 would index (and overwrite) the last block of every frame."""
        b, r, s = prev_img.shape
        k = blocks.shape[-1]
        nblocks = (r * s) // k
        buf = torch.cat(
            [prev_img.reshape(b, nblocks, k), prev_img.new_zeros((b, 1, k))], dim=1)
        safe = torch.where(idx < 0, nblocks, idx)
        buf.scatter_(1, safe[:, :, None].expand(-1, -1, k), blocks)
        return buf[:, :nblocks].reshape(b, r, s)

    def ingest_stage(yuv):
        """I420 -> RGB uint8; a batch of active rows (rows < size) gets its
        dead rows padded back black, as the host letterbox would."""
        rgb = yuv420_to_rgb(yuv).to(torch.uint8)
        rows, size = rgb.shape[1], rgb.shape[2]
        if rows < size:
            top = (size - rows) // 2
            rgb = torch.nn.functional.pad(rgb, (0, 0, 0, 0, top, size - rows - top))
        return rgb

    def pack_stage(dets, crop_out, emb_out, match_out):
        """Every per-face scalar output in ONE [B, M, 22] f32 tensor
        (PACKED_LAYOUT), so a fetch is one device->host copy."""
        cols = [
            dets["boxes"],                                   # 0:4
            dets["landmarks"],                               # 4:14
            dets["scores"][..., None],                       # 14
            dets["valid"][..., None],                        # 15
            match_out["best_idx"][..., None],                # 16
            match_out["best_distance"][..., None],           # 17
            match_out["is_match"][..., None],                # 18
            emb_out["fake_prob"][..., None],                 # 19
            crop_out["quality"][..., None],                  # 20
            crop_out["blur_score"][..., None],               # 21
        ]
        return torch.cat([c.to(torch.float32) for c in cols], dim=-1)

    def delta_ingest_stage(prev_img, idx, blocks):
        new_prev = delta_stage(prev_img, idx, blocks)
        return new_prev, ingest_stage(new_prev)

    def match_pack_stage(dets, crop_out, emb_out, gallery, gallery_valid, tol):
        mo = match_stage(emb_out["embeddings_flat"], dets["valid"], gallery, gallery_valid, tol)
        return pack_stage(dets, crop_out, emb_out, mo)

    return {
        "ingest": ingest_stage,
        "detect": detect_stage,
        "crop": crop_stage,
        "embed": embed_stage,
        "match": match_stage,
        "delta_ingest": delta_ingest_stage,
        "match_pack": match_pack_stage,
    }


def full_tree(dets, cropped, emb, matched) -> dict:
    """The stages' outputs as one result dict: every per-face output, the
    embeddings and the top-k included, the crops left out."""
    return {
        **dets,
        **{k: v for k, v in cropped.items() if k != "crops"},
        **{k: v for k, v in emb.items() if k != "embeddings_flat"},
        **matched,
    }


def build_pipeline(
    *,
    device=None,
    det_size: int = 640,
    max_faces: int = 16,
    pre_nms_topk: int = 256,
    conf_thresh: float = 0.5,
    nms_thresh: float = 0.4,
    iom_thresh: float = 0.5,
    tolerance: float = 0.6,
    top_k: int = 5,
    compute_dtype: str = "bfloat16",
    distance_scale: float = 1.0,
):
    """The single-program pipeline (``frp_tpu/engine/pipeline.py::build_pipeline``):
    returns ``pipeline(params, frames, gallery, gallery_valid, priors)`` ->
    dict of boxes [B, M, 4], scores, landmarks [B, M, 10], valid, count [B],
    embeddings [B, M, D], best_idx, best_distance, is_match, topk_idx,
    topk_distance [B, M, top_k], fake_prob, quality, blur_score; all tensors
    on ``device``, all knobs fixed here. ``params`` holds the converted
    ``detector``, ``embedder`` and ``spoof`` trees, ``frames`` is [B, H, W, 3]
    uint8 RGB, ``priors`` the anchors of ``det_size``.

    It chains the stages of ``build_stages``; its head is decode +
    ``nms_padded_batched``, never the fused head, as the reference's: on the
    card a call launches kernel 3 and kernel 2 once each. Spoof and quality
    are always on, as in ``build_stages``. ``device=None`` means the card and
    raises without it."""
    device = resolve_device(device)
    stages = build_stages(
        device=device, det_size=det_size, max_faces=max_faces, pre_nms_topk=pre_nms_topk,
        conf_thresh=conf_thresh, nms_thresh=nms_thresh, iom_thresh=iom_thresh,
        top_k=top_k, compute_dtype=compute_dtype, fused_head=False, compact=False)

    @torch.no_grad()
    def pipeline(params, frames, gallery, gallery_valid, priors):
        dets = stages["detect"](params["detector"], frames, priors)
        cropped = stages["crop"](frames, dets)
        emb = stages["embed"](params, cropped["crops"], dets["valid"], distance_scale)
        matched = stages["match"](
            emb["embeddings_flat"], dets["valid"], gallery, gallery_valid, float(tolerance))
        return full_tree(dets, cropped, emb, matched)

    return pipeline


# column layout of the pack_stage output (see unpack_packed)
PACKED_LAYOUT = {
    "boxes": (0, 4),
    "landmarks": (4, 14),
    "scores": (14, 15),
    "valid": (15, 16),
    "best_idx": (16, 17),
    "best_distance": (17, 18),
    "is_match": (18, 19),
    "fake_prob": (19, 20),
    "quality": (20, 21),
    "blur_score": (21, 22),
}
PACKED_WIDTH = 22


def unpack_packed(arr: np.ndarray) -> dict:
    """Host-side inverse of pack_stage: [B, M, 22] f32 -> result dict with
    the same keys/dtypes as the full-tree path (embeddings/topk excluded)."""
    arr = np.asarray(arr)
    out: dict = {}
    for key, (lo, hi) in PACKED_LAYOUT.items():
        v = arr[..., lo:hi]
        out[key] = v if hi - lo > 1 else v[..., 0]
    out["valid"] = out["valid"] > 0.5
    out["is_match"] = out["is_match"] > 0.5
    out["best_idx"] = out["best_idx"].astype(np.int32)
    out["count"] = out["valid"].sum(axis=1).astype(np.int32)
    out["best_distance"] = np.where(out["valid"], out["best_distance"], np.inf)
    return out


def to_host(tensors: list) -> list:
    """numpy copies of ``tensors`` with ONE device-to-host copy: their bytes
    are joined on the device first, the widest elements first so that every
    array lands aligned in the joined buffer."""
    if not tensors:
        return []
    order = sorted(range(len(tensors)), key=lambda i: -tensors[i].element_size())
    flat = [tensors[i].contiguous().reshape(-1).view(torch.uint8) for i in order]
    host = torch.cat(flat).cpu().numpy()
    out: list = [None] * len(tensors)
    at = 0
    for i, f in zip(order, flat):
        t, n = tensors[i], f.numel()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out[i] = host[at : at + n].view(dtype).reshape(tuple(t.shape))
        at += n
    return out


@dataclass
class EngineMetrics:
    """Reference-parity runtime counters (face_service.py:67-77 semantics)."""

    total_batches: int = 0
    total_frames: int = 0
    total_faces: int = 0
    total_device_time: float = 0.0

    def as_dict(self) -> dict:
        avg = self.total_device_time / max(self.total_batches, 1)
        return {
            "total_batches": self.total_batches,
            "total_frames": self.total_frames,
            "total_faces_detected": self.total_faces,
            "total_processing_time": round(self.total_device_time, 4),
            "average_batch_time": round(avg, 4),
            "frames_per_second": round(
                self.total_frames / max(self.total_device_time, 1e-9), 2
            ),
        }


def load_any(path: str, ref_tree: dict) -> dict:
    """A weights file as a numpy tree in the JAX layouts: an npz through
    ``load_params``; an ONNX export mapped onto a copy of ``ref_tree`` (the
    init tree) by its node execution order, or, for a node-free tensor dump,
    by its dotted names (``frp_tpu/engine/pipeline.py:815-842``). Raises
    ValueError on an unreadable file or a structure mismatch."""
    if not path.endswith(".onnx"):
        return load_params(path)
    return load_onnx(path, ref_tree)


def load_onnx(path: str, ref_tree: dict) -> dict:
    """An ONNX export, whatever its file name, mapped onto a copy of
    ``ref_tree``: the ONNX half of ``load_any``."""
    graph = load_onnx_graph(path)
    if graph is None:
        raise ValueError("unreadable/empty onnx")
    # a deep copy keeps the dict order, which the importer walks by
    new = copy.deepcopy(ref_tree)
    if graph["nodes"]:
        import_onnx_graph(new, graph)
    else:
        import_onnx_weights(new, graph["initializers"])
    return new


class RecognitionEngine:
    """Host-facing wrapper: params + gallery + stages + metrics.

    ``device=None`` means the card ("cuda"), and raises when there is none;
    ``device="cpu"`` runs every stage on the CPU, where the kernels' plain
    versions stand in for them. Thread-safe for concurrent callers of the
    metrics; batches are dispatched in call order.
    """

    def __init__(
        self,
        cfg: Config | None = None,
        device=None,
        seed: int = 0,
        allow_stale_calibration: bool = False,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg or get_config()
        arch = self.cfg.embedder_arch
        self._allow_stale_calibration = allow_stale_calibration
        self.preferred_fmt = "yuv420"
        if arch.startswith("iresnet"):
            embedder = init_iresnet(seed + 1, variant=arch, embed_dim=self.cfg.embed_dim)
            embedder_forward = iresnet_forward
        else:
            embedder = init_mobilefacenet(seed + 1, embed_dim=self.cfg.embed_dim)
            embedder_forward = mobilefacenet_forward
        host_params = {
            "detector": init_retinaface(seed),
            "embedder": embedder,
            "spoof": init_mobilenetv3_small(seed + 2, num_classes=2),
        }
        self.weights_loaded = self._load_weights(host_params, arch)
        self.distance_scale = self._load_calibration()
        self.params = {k: convert_params(v, self.device) for k, v in host_params.items()}
        self.gallery = DeviceGallery(embed_dim=self.cfg.embed_dim, device=self.device)
        self.metrics = EngineMetrics()
        self._lock = threading.Lock()
        self._priors = torch.from_numpy(generate_anchors(self.cfg.det_size).copy()).to(self.device)
        self._stages = build_stages(
            device=self.device,
            det_size=self.cfg.det_size,
            max_faces=self.cfg.max_faces_per_frame,
            pre_nms_topk=self.cfg.pre_nms_topk,
            conf_thresh=self.cfg.det_conf_threshold,
            nms_thresh=self.cfg.det_nms_threshold,
            iom_thresh=self.cfg.det_nms_iom_threshold,
            compute_dtype=self.cfg.compute_dtype,
            embedder_forward=embedder_forward,
            flip_tta=self.cfg.embed_flip_tta,
        )
        # put_payload's uploads run on a stream of their own, so that they
        # overlap the scan's work instead of queueing behind it
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        # device-resident previous I420 batch for delta transfer
        # (submit_encoded); None until the first raw keyframe
        self._delta_prev = None
        # (enc_id, seq) of the payload the resident batch came from
        self._delta_src: tuple[int, int] | None = None
        self.delta_stats = {"keyframes": 0, "deltas": 0, "desyncs": 0}
        # when a list, each stage boundary appends (stage name, CUDA event)
        # — a per-stage device timeline for measurement runs; None is off
        self.stage_events: list | None = None

    def _mark(self, name: str) -> None:
        if self.stage_events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.stage_events.append((name, ev))

    # -- weights ----------------------------------------------------------
    def _load_calibration(self) -> float:
        """Distance-scale constant from the calibration file beside the
        loaded embedder weights (1.0 when absent or when no trained embedder
        loaded). The file is keyed by arch and mode: with flip-TTA only
        calibration_{arch}_flip.json, else calibration_{arch}.json and, for
        MobileFaceNet, calibration.json; a file whose ``flip_tta`` differs
        from the engine's mode is skipped. An embedder loaded from ONNX gets
        no calibration (1.0), as in the JAX engine. A calibration whose recorded
        weights sha256 differs from the loaded files is refused, unless the
        engine was built with allow_stale_calibration (then it runs
        uncalibrated)."""
        emb_path = self.weights_loaded.get("embedder")
        if not emb_path:
            return 1.0
        if emb_path.endswith(".onnx"):
            # a calibration beside a user's export was measured for other
            # weights or not at all: the JAX engine applies none
            # (frp_tpu/engine/pipeline.py:709-719), and neither does the port
            logger.warning(
                "embedder loaded from %s: skipping shipped distance "
                "calibration; run tools/calibrate_embedder.py to measure a "
                "scale for these weights", emb_path)
            return 1.0
        arch = self.cfg.embedder_arch
        flip = bool(self.cfg.embed_flip_tta)
        wd = os.path.dirname(emb_path)
        if flip:
            names = [f"calibration_{arch}_flip.json"]
        else:
            names = [f"calibration_{arch}.json"]
            if arch == "mobilefacenet":
                names.append("calibration.json")
        for name in names:
            try:
                with open(os.path.join(wd, name)) as f:
                    cal = json.load(f)
                scale = float(cal["distance_scale"])
            except (OSError, KeyError, ValueError, TypeError):
                continue
            if bool(cal.get("flip_tta", False)) != flip:
                continue  # a hand-renamed file must not cross modes
            for key, path in (("weights_sha256", emb_path),
                              ("detector_sha256", self.weights_loaded.get("detector"))):
                expect = cal.get(key)
                if not (expect and path):
                    continue
                got = weights_fingerprint(path)
                if got != expect:
                    if self._allow_stale_calibration:
                        logger.warning(
                            "%s fingerprint mismatch (%s); running UNCALIBRATED "
                            "(scale 1.0)", name, key)
                        return 1.0
                    flag = " --flip" if flip else ""
                    raise RuntimeError(
                        f"{name} was calibrated for {key.split('_')[0]} weights "
                        f"sha256={expect[:12]}… but {path} has sha256={got[:12]}…: "
                        "the distance scale does not correspond to these "
                        f"weights. Re-run tools/calibrate_embedder.py --arch {arch}{flag} "
                        f"(and tools/tiered_eval.py --arch {arch}{flag}) and commit "
                        "weights + artifacts together."
                    )
            return scale
        if flip or arch != "mobilefacenet":
            logger.warning(
                "no %s beside %s: distances are on the raw embedder scale "
                "(run tools/calibrate_embedder.py --arch %s%s)",
                names[0], emb_path, arch, " --flip" if flip else "")
        return 1.0

    def _load_weights(self, host_params: dict, arch: str) -> dict:
        """Load trained weights from cfg.weights_dir (relative to the cwd,
        then to the repository root) over the seeded init. Candidates per
        model, first successful load wins: retinaface.onnx / retinaface.npz /
        retinaface_synthetic.npz, embedder.onnx / {arch}.npz / embedder.npz,
        spoof.onnx / spoof.npz / mobilenetv3.npz. A user's ONNX export
        outranks the shipped npz. A file must match the init tree's key paths
        and shapes. Then the conv padding switch of
        ``frp_tpu/engine/pipeline.py:879-904``: weights all from ONNX switch
        the global mode to "torch" unless CONV_PADDING is set; ONNX beside
        npz keeps the mode and warns. Returns {model: path or None}."""
        loaded: dict = {}
        wd = self.cfg.weights_dir
        roots = [wd, os.path.join(_REPO_ROOT, wd)]
        candidates = {
            "detector": ["retinaface.onnx", "retinaface.npz", "retinaface_synthetic.npz"],
            "embedder": ["embedder.onnx", f"{arch}.npz", "embedder.npz"],
            "spoof": ["spoof.onnx", "spoof.npz", "mobilenetv3.npz"],
        }
        for model, names in candidates.items():
            loaded[model] = None
            for root in roots:
                for name in names:
                    path = os.path.join(root, name)
                    if not os.path.exists(path):
                        continue
                    try:
                        new = load_any(path, host_params[model])
                        # key paths, not only shapes: two shape-identical
                        # subtrees under other names must not load crossed
                        if not same_structure(host_params[model], new):
                            raise ValueError("structure mismatch")
                        host_params[model] = new
                        loaded[model] = path
                        break  # a corrupt first candidate falls through
                    except (ValueError, OSError, KeyError) as e:
                        logger.warning("weights %s not loaded: %s", path, e)
                if loaded[model]:
                    break
        onnx_models = [m for m, p in loaded.items() if p and p.endswith(".onnx")]
        if onnx_models and "CONV_PADDING" not in os.environ:
            npz_models = [m for m, p in loaded.items() if p and not p.endswith(".onnx")]
            if npz_models:
                # one global mode cannot fit both: keep it, and say which
                # models run under another padding than they were trained on
                logger.warning(
                    "mixed weight provenance (onnx: %s, npz: %s): conv padding "
                    "mode stays '%s'; set CONV_PADDING=torch if the onnx "
                    "models matter more, or convert all weights to one format",
                    onnx_models, npz_models, nn._PADDING_MODE)
            elif nn._PADDING_MODE != "torch":
                logger.warning(
                    "onnx checkpoints loaded (%s): switching conv padding to "
                    "'torch' (override with CONV_PADDING)", onnx_models)
                nn.set_padding_mode("torch")
        return loaded

    # -- staged dispatch --------------------------------------------------
    def _upload(self, arr: np.ndarray, copy: bool = False) -> torch.Tensor:
        """numpy -> engine device. ``copy`` forces a private copy on the CPU
        (``torch.from_numpy`` aliases numpy memory); the card always gets
        its own copy, staged through pinned memory so the transfer does not
        wait for the work already queued."""
        if copy or not arr.flags.writeable:
            arr = np.array(arr, copy=True)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _payload_tensor(self, x, dtype, copy: bool = False) -> torch.Tensor:
        """A payload array on the engine's device. A tensor (``put_payload``'s)
        is taken as it is where it already lies there, and marked as used by
        the current stream, so that the caching allocator does not hand its
        memory out while this stream's work may still read it; anything else
        is uploaded (``copy`` as in ``_upload``)."""
        if isinstance(x, torch.Tensor):
            x = x.to(self.device, getattr(torch, np.dtype(dtype).name))
            if x.is_cuda:
                x.record_stream(torch.cuda.current_stream(x.device))
            return x
        return self._upload(np.asarray(x, dtype=dtype), copy=copy)

    def _run_stages(self, frames_dev, tolerance: float, fmt: str = "rgb", packed: bool = True):
        """Chain the stages; returns (device result, gallery names snapshot
        tied to the gallery tensors this batch matched against). The result
        is the packed [B, M, 22] tensor, or with packed=False the full dict
        (embeddings and top-k included)."""
        gal, gal_valid, gal_names = self.gallery.device_view()
        if fmt == "yuv420":
            frames_dev = self._stages["ingest"](frames_dev)
            self._mark("ingest")
        dets = self._stages["detect"](self.params["detector"], frames_dev, self._priors)
        self._mark("detect")
        cropped = self._stages["crop"](frames_dev, dets)
        self._mark("crop")
        emb = self._stages["embed"](
            self.params, cropped["crops"], dets["valid"], self.distance_scale)
        self._mark("embed")
        if packed:
            out = self._stages["match_pack"](
                dets, cropped, emb, gal, gal_valid, float(tolerance))
            self._mark("match_pack")
            return out, gal_names
        matched = self._stages["match"](
            emb["embeddings_flat"], dets["valid"], gal, gal_valid, float(tolerance))
        self._mark("match")
        return full_tree(dets, cropped, emb, matched), gal_names

    def _record(self, b: int, count: np.ndarray, seconds: float) -> None:
        with self._lock:
            self.metrics.total_batches += 1
            self.metrics.total_frames += b
            self.metrics.total_faces += int(count.sum())
            self.metrics.total_device_time += seconds

    # -- main entry -------------------------------------------------------
    @torch.no_grad()
    def process_frames(self, frames: np.ndarray, tolerance: float | None = None,
                       fmt: str = "rgb", record_metrics: bool = True):
        """frames: [B, H, W, 3] uint8 RGB, or [B, H*3//2, W] uint8 I420 with
        fmt="yuv420". Returns a host dict of numpy arrays (padded slots +
        masks), embeddings and top-k included. ``record_metrics=False``
        leaves the engine's counters alone (warmup)."""
        tolerance = self.cfg.face_tolerance if tolerance is None else tolerance
        frames = np.ascontiguousarray(frames, dtype=np.uint8)
        if frames.ndim == 3 and fmt == "rgb":
            frames = frames[None]
        b = frames.shape[0]
        t0 = time.perf_counter()
        out, gal_names = self._run_stages(self._upload(frames), tolerance, fmt, packed=False)
        out = dict(zip(out.keys(), to_host(list(out.values()))))
        out["gallery_names"] = gal_names
        dt = time.perf_counter() - t0
        if record_metrics:
            self._record(b, out["count"], dt)
        out["processing_time"] = dt
        return out

    @torch.no_grad()
    def encode_image(self, image: np.ndarray):
        """Detect + embed one RGB image of any geometry (enrolment). Returns a
        list of face dicts (embedding, box, landmarks, score, quality,
        fake_prob) with coordinates in the original image's pixels; a
        non-square image is letterboxed on the host to the det square."""
        size = self.cfg.det_size
        h, w = image.shape[:2]
        scale, off = 1.0, (0.0, 0.0)
        if (h, w) != (size, size):
            image, scale, off = letterbox(np.ascontiguousarray(image), size)
        out = self.process_frames(image[None])
        if scale != 1.0 or off != (0.0, 0.0):
            ox, oy = off
            off4 = np.array([ox, oy, ox, oy], np.float32)
            off10 = np.tile(np.array([ox, oy], np.float32), 5)
            out["boxes"] = np.clip((out["boxes"] - off4) / scale, 0, [w, h, w, h])
            out["landmarks"] = (out["landmarks"] - off10) / scale
        faces = []
        for i in range(out["valid"].shape[1]):
            if not out["valid"][0, i]:
                continue
            faces.append({
                "embedding": out["embeddings"][0, i],
                "box": out["boxes"][0, i],
                "landmarks": out["landmarks"][0, i],
                "score": float(out["scores"][0, i]),
                "quality": float(out["quality"][0, i]),
                "fake_prob": float(out["fake_prob"][0, i]),
            })
        return faces

    @torch.no_grad()
    def warmup(self, batch: int, h: int | None = None, w: int | None = None):
        """Run one batch of black RGB frames [batch, h, w, 3] (det square by
        default) through every stage before serving, without touching the
        counters: on the card the first call builds the kernels (nvcc) and
        picks cuDNN's algorithms. A failure raises."""
        h = h or self.cfg.det_size
        w = w or self.cfg.det_size
        self.process_frames(np.zeros((batch, h, w, 3), np.uint8), record_metrics=False)

    @torch.no_grad()
    def submit(self, frames: np.ndarray, tolerance: float | None = None,
               fmt: str = "rgb", packed: bool = True):
        """Queue a batch on the device without waiting; returns a handle for
        fetch(). With ``packed`` (default) the result is the [B, M, 22]
        layout, one device-to-host copy a fetch; ``packed=False`` keeps every
        output, embeddings and top-k included."""
        tolerance = self.cfg.face_tolerance if tolerance is None else tolerance
        frames = np.ascontiguousarray(frames, dtype=np.uint8)
        if frames.ndim == 3 and fmt == "rgb":
            frames = frames[None]
        out, gal_names = self._run_stages(self._upload(frames), tolerance, fmt, packed)
        return out, frames.shape[0], packed, gal_names, time.perf_counter()

    @torch.no_grad()
    def submit_encoded(self, enc, tolerance: float | None = None, packed: bool = True):
        """Submit a DeltaEncoder.encode() payload. "raw" keyframes upload the
        full I420 batch and become the resident batch; "delta" payloads ship
        only changed blocks, which the delta stage scatters onto the resident
        batch (bit-exact). A tagged delta must continue the exact payload
        stream the resident batch came from, or it raises. Takes
        ``put_payload``'s payloads without another copy. ``packed`` as in
        ``submit``. Returns a fetch() / fetch_many() handle."""
        tolerance = self.cfg.face_tolerance if tolerance is None else tolerance
        tag = (enc.enc_id, enc.seq) if hasattr(enc, "enc_id") and hasattr(enc, "seq") else None
        self._mark("start")
        if enc[0] == "raw":
            # COPY: the upload is retained as the resident batch, and on the
            # CPU torch.from_numpy aliases numpy memory — a caller reusing
            # its batch buffer would corrupt every later reconstruction
            frames_dev = self._payload_tensor(enc[1], np.uint8, copy=True)
            self.delta_stats["keyframes"] += 1
            self._delta_prev = frames_dev
            if tag is not None:
                self._delta_src = tag
            out, gal_names = self._run_stages(frames_dev, tolerance, "yuv420", packed)
            return out, int(frames_dev.shape[0]), packed, gal_names, time.perf_counter()
        _, idx, blocks = enc
        if self._delta_prev is None:
            raise RuntimeError(
                "delta payload before any raw keyframe (encoder/engine state "
                "out of sync — call DeltaEncoder.reset())"
            )
        if tag is not None and self._delta_src is not None:
            want_id, want_seq = self._delta_src
            if tag[0] != want_id or tag[1] != want_seq + 1:
                self.delta_stats["desyncs"] += 1
                raise RuntimeError(
                    f"delta payload desync: engine resident batch is from "
                    f"encoder {want_id} seq {want_seq}, payload is from "
                    f"encoder {tag[0]} seq {tag[1]} (expected seq "
                    f"{want_seq + 1}). Reset the encoder; the next encode "
                    "ships a raw keyframe."
                )
        idx_dev = self._payload_tensor(idx, np.int64)
        blocks_dev = self._payload_tensor(blocks, np.uint8)
        new_prev, rgb_dev = self._stages["delta_ingest"](self._delta_prev, idx_dev, blocks_dev)
        self._mark("delta_ingest")
        self.delta_stats["deltas"] += 1
        self._delta_prev = new_prev
        if tag is not None:
            self._delta_src = tag
        out, gal_names = self._run_stages(rgb_dev, tolerance, "rgb", packed)
        return out, int(rgb_dev.shape[0]), packed, gal_names, time.perf_counter()

    @torch.no_grad()
    def put_payload(self, enc):
        """Upload a DeltaEncoder payload's arrays to the engine's device ahead
        of ``submit_encoded``, keeping its (enc_id, seq) tag; returns a
        payload ``submit_encoded`` takes without another copy. Meant for a
        transfer thread beside the thread that submits: on the card the
        copies run on a stream of their own and this call returns when they
        have landed, so they overlap the scan's work and the scan never reads
        a half-written block. A raw keyframe is copied (it becomes the
        resident batch, as in ``submit_encoded``); arrays that are tensors on
        the device already are kept as they are. Payloads must still reach
        ``submit_encoded`` in encode order (the seq guard enforces it)."""
        tag = (enc.enc_id, enc.seq) if hasattr(enc, "enc_id") and hasattr(enc, "seq") else None
        side = self._copy_stream
        with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
            if enc[0] == "raw":
                data = ("raw", self._payload_tensor(enc[1], np.uint8, copy=True))
            else:
                _, idx, blocks = enc
                data = ("delta", self._payload_tensor(idx, np.int64),
                        self._payload_tensor(blocks, np.uint8))
        if side is not None:
            side.synchronize()
        return DeltaPayload(data, *tag) if tag is not None else data

    def precompile_delta_rungs(self, block: int | None = None) -> int:
        """Run the delta stage once at every DeltaEncoder ladder rung for the
        resident batch's shape, with all-padding payloads (idx = -1, which
        rebuild the resident batch bit for bit), so a live stream's first
        payload at each rung meets a warm allocator and cuDNN's algorithm
        choice for its shapes. Needs a raw keyframe through
        ``submit_encoded`` first; returns the number of rungs run (0 with no
        resident batch or a shape that does not block-align). ``block`` is
        the encoder's block size, FRP_DELTA_BLOCK (128) when None."""
        if self._delta_prev is None:
            return 0
        shape = self._delta_prev.shape
        b = int(shape[0])
        nbytes = int(np.prod(shape[1:]))
        block = block or int(os.getenv("FRP_DELTA_BLOCK", "128"))
        if b == 0 or nbytes % block:
            return 0
        nblocks = nbytes // block
        done = 0
        for denom in DeltaEncoder.LADDER:
            cap = nblocks // denom
            if cap == 0:
                continue
            idx = np.full((b, cap), -1, np.int32)
            blocks = np.zeros((b, cap, block), np.uint8)
            # untagged: the seq guard skips it and keeps the live stream's tag
            self.fetch(self.submit_encoded(("delta", idx, blocks)))
            done += 1
        return done

    @torch.no_grad()
    def fetch(self, handle):
        """Wait for a submit() handle and return host-side results: the
        unpacked [B, M, 22] layout, or with packed=False every output as a
        numpy array; both carry ``gallery_names``. One device-to-host copy
        either way."""
        return self.fetch_many([handle])[0]

    @torch.no_grad()
    def fetch_many(self, handles: list) -> list:
        """Fetch a group of submit() handles, packed or not, with ONE
        device-to-host copy (``to_host``). Returns the host-side result dicts
        in submission order."""
        if not handles:
            return []
        leaves = [[o] if is_packed else list(o.values()) for o, _, is_packed, _, _ in handles]
        host = iter(to_host([t for group in leaves for t in group]))
        now = time.perf_counter()
        results = []
        for (o, b, is_packed, gal_names, t_submit), group in zip(handles, leaves):
            arrays = [next(host) for _ in group]
            out = unpack_packed(arrays[0]) if is_packed else dict(zip(o.keys(), arrays))
            out["gallery_names"] = gal_names
            self._record(b, out["count"], max(0.0, now - t_submit))
            results.append(out)
        return results
