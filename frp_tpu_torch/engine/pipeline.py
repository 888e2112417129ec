"""The recognition pipeline on PyTorch (port of ``frp_tpu/engine/pipeline.py``,
default throughput profile): frames -> detections -> aligned crops ->
embeddings (+ spoof) -> gallery matches, as chained stages whose
intermediates stay on the device.

    I420 payload (DeltaEncoder)    host
      └ delta_ingest: block scatter onto the resident batch, BT.601, pad
      └ detect: RetinaFace -> top-K -> fused head    (ops/detection_cuda.py, kernel 1)
      └ crop: 5-point similarity -> bilinear warp    (ops/align_cuda.py, kernel 2)
              + quality scores
      └ embed: MobileFaceNet x distance scale, MobileNetV3 spoof
      └ match_pack: gallery match, packed [B, M, 22]
    fetch: one device->host copy, unpacked on the host

``pre_nms_topk`` > 256 routes detect through decode + ``nms_padded_batched``,
whose greedy pass is kernel 3 (``ops/nms_cuda.py``). Everything is
shape-static: M = max_faces slots per frame with validity masks.

Not ported yet (ROADMAP): the accuracy profile (iresnet, flip-TTA, embed
compaction rungs), ``put_payload``, ``fetch_many``,
``precompile_delta_rungs``, ONNX/.pth import and mesh sharding.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from frp_tpu_torch.config import Config, get_config
from frp_tpu_torch.engine.batching import letterbox
from frp_tpu_torch.engine.gallery import DeviceGallery
from frp_tpu_torch.models.mobilefacenet import init_mobilefacenet, mobilefacenet_forward
from frp_tpu_torch.models.mobilenetv3 import init_mobilenetv3_small, mobilenetv3_forward
from frp_tpu_torch.models.params import convert_params, load_params, same_structure
from frp_tpu_torch.models.retinaface import init_retinaface, retinaface_forward
from frp_tpu_torch.ops.align import (
    ARCFACE_TEMPLATE_112,
    similarity_transform,
    warp_crops_batched,
)
from frp_tpu_torch.ops.anchors import generate_anchors
from frp_tpu_torch.ops.detection_cuda import fused_detection_head
from frp_tpu_torch.ops.image import (
    normalize_face,
    normalize_imagenet,
    preprocess_frames,
    yuv420_to_rgb,
)
from frp_tpu_torch.ops.matching import gallery_match
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
):
    """The pipeline as chained stage functions (the JAX package's
    ``build_stages`` without its accuracy-profile options). Constants live on
    ``device`` once, so no stage copies host data to the card."""
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
        dets = fused_detection_head(
            det["loc"], det["ldm"], det["score"], priors,
            pre_topk=pre_nms_topk,
            max_out=max_faces,
            conf_thresh=conf_thresh,
            iou_thresh=nms_thresh,
            iom_thresh=iom_thresh,
            image_size=float(det_size),
        )
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

    def embed_stage(params, crops, valid, scale=1.0):
        b, m = crops.shape[0], crops.shape[1]
        flat = crops.reshape(b * m, 112, 112, 3)
        vflat = valid.reshape(-1)
        emb = mobilefacenet_forward(params["embedder"], normalize_face(flat).to(cdtype))
        # distance-scale calibration (weights/calibration.json): scaling
        # the embeddings scales every euclidean distance downstream
        logits = mobilenetv3_forward(params["spoof"], normalize_imagenet(flat).to(cdtype))
        fake = torch.softmax(logits, dim=-1)[:, 1].reshape(b, m)
        return {
            "embeddings_flat": torch.where(vflat[:, None], emb * scale, 0.0),
            "fake_prob": torch.where(valid, fake, 0.0),
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
        if arch != "mobilefacenet" or self.cfg.embed_flip_tta:
            raise NotImplementedError(
                f"embedder_arch={arch!r}, embed_flip_tta={self.cfg.embed_flip_tta}: "
                "the accuracy profile is not ported yet (ROADMAP Queue 1, "
                "accuracy profile)"
            )
        self._allow_stale_calibration = allow_stale_calibration
        self.preferred_fmt = "yuv420"
        host_params = {
            "detector": init_retinaface(seed),
            "embedder": init_mobilefacenet(seed + 1, embed_dim=self.cfg.embed_dim),
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
        )
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
        """Distance-scale constant from calibration.json beside the loaded
        embedder weights (1.0 when absent or when no trained embedder
        loaded). A calibration whose recorded weights sha256 differs from
        the loaded files is refused, unless the engine was built with
        allow_stale_calibration (then it runs uncalibrated)."""
        emb_path = self.weights_loaded.get("embedder")
        if not emb_path:
            return 1.0
        wd = os.path.dirname(emb_path)
        for name in ("calibration_mobilefacenet.json", "calibration.json"):
            try:
                with open(os.path.join(wd, name)) as f:
                    cal = json.load(f)
                scale = float(cal["distance_scale"])
            except (OSError, KeyError, ValueError, TypeError):
                continue
            if bool(cal.get("flip_tta", False)):
                continue  # a flip-TTA scale must not cross modes
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
                    raise RuntimeError(
                        f"{name} was calibrated for {key.split('_')[0]} weights "
                        f"sha256={expect[:12]}… but {path} has sha256={got[:12]}…: "
                        "the distance scale does not correspond to these "
                        "weights. Re-run tools/calibrate_embedder.py and commit "
                        "weights + artifacts together."
                    )
            return scale
        return 1.0

    def _load_weights(self, host_params: dict, arch: str) -> dict:
        """Load trained weights from cfg.weights_dir (relative to the cwd,
        then to the repository root) over the seeded init. Candidates per
        model, first successful load wins: retinaface.npz /
        retinaface_synthetic.npz, {arch}.npz / embedder.npz, spoof.npz /
        mobilenetv3.npz. A file must match the init tree's key paths and
        shapes. An ``.onnx`` candidate, which the JAX engine would load
        first, raises: the port does not import ONNX yet."""
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
                    if name.endswith(".onnx"):
                        raise NotImplementedError(
                            f"{path}: ONNX weights are not imported by the "
                            "PyTorch port yet (ROADMAP Queue 1, ONNX and .pth "
                            "import); the JAX engine would load this file"
                        )
                    try:
                        new = load_params(path)
                        if not same_structure(host_params[model], new):
                            raise ValueError("structure mismatch")
                        host_params[model] = new
                        loaded[model] = path
                        break
                    except (ValueError, OSError, KeyError) as e:
                        logger.warning("weights %s not loaded: %s", path, e)
                if loaded[model]:
                    break
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
        out = {
            **dets,
            **{k: v for k, v in cropped.items() if k != "crops"},
            **{k: v for k, v in emb.items() if k != "embeddings_flat"},
            **matched,
        }
        return out, gal_names

    def _record(self, b: int, count: np.ndarray, seconds: float) -> None:
        with self._lock:
            self.metrics.total_batches += 1
            self.metrics.total_frames += b
            self.metrics.total_faces += int(count.sum())
            self.metrics.total_device_time += seconds

    # -- main entry -------------------------------------------------------
    @torch.no_grad()
    def process_frames(self, frames: np.ndarray, tolerance: float | None = None,
                       fmt: str = "rgb"):
        """frames: [B, H, W, 3] uint8 RGB, or [B, H*3//2, W] uint8 I420 with
        fmt="yuv420". Returns a host dict of numpy arrays (padded slots +
        masks), embeddings and top-k included."""
        tolerance = self.cfg.face_tolerance if tolerance is None else tolerance
        frames = np.ascontiguousarray(frames, dtype=np.uint8)
        if frames.ndim == 3 and fmt == "rgb":
            frames = frames[None]
        b = frames.shape[0]
        t0 = time.perf_counter()
        out, gal_names = self._run_stages(self._upload(frames), tolerance, fmt, packed=False)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        out["gallery_names"] = gal_names
        dt = time.perf_counter() - t0
        self._record(b, out["count"], dt)
        out["processing_time"] = dt
        return out

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
    def submit(self, frames: np.ndarray, tolerance: float | None = None,
               fmt: str = "rgb"):
        """Queue a batch on the device without waiting; returns a handle for
        fetch(), which unpacks the [B, M, 22] layout."""
        tolerance = self.cfg.face_tolerance if tolerance is None else tolerance
        frames = np.ascontiguousarray(frames, dtype=np.uint8)
        if frames.ndim == 3 and fmt == "rgb":
            frames = frames[None]
        out, gal_names = self._run_stages(self._upload(frames), tolerance, fmt)
        return out, frames.shape[0], gal_names, time.perf_counter()

    @torch.no_grad()
    def submit_encoded(self, enc, tolerance: float | None = None):
        """Submit a DeltaEncoder.encode() payload. "raw" keyframes upload the
        full I420 batch and become the resident batch; "delta" payloads ship
        only changed blocks, which the delta stage scatters onto the resident
        batch (bit-exact). A tagged delta must continue the exact payload
        stream the resident batch came from, or it raises. Returns a fetch()
        handle."""
        tolerance = self.cfg.face_tolerance if tolerance is None else tolerance
        tag = (enc.enc_id, enc.seq) if hasattr(enc, "enc_id") and hasattr(enc, "seq") else None
        self._mark("start")
        if enc[0] == "raw":
            # COPY: the upload is retained as the resident batch, and on the
            # CPU torch.from_numpy aliases numpy memory — a caller reusing
            # its batch buffer would corrupt every later reconstruction
            frames_dev = self._upload(np.asarray(enc[1], dtype=np.uint8), copy=True)
            self.delta_stats["keyframes"] += 1
            self._delta_prev = frames_dev
            if tag is not None:
                self._delta_src = tag
            out, gal_names = self._run_stages(frames_dev, tolerance, "yuv420")
            return out, int(frames_dev.shape[0]), gal_names, time.perf_counter()
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
        idx_dev = self._upload(np.asarray(idx, dtype=np.int64))
        blocks_dev = self._upload(np.asarray(blocks, dtype=np.uint8))
        new_prev, rgb_dev = self._stages["delta_ingest"](self._delta_prev, idx_dev, blocks_dev)
        self._mark("delta_ingest")
        self.delta_stats["deltas"] += 1
        self._delta_prev = new_prev
        if tag is not None:
            self._delta_src = tag
        out, gal_names = self._run_stages(rgb_dev, tolerance, "rgb")
        return out, int(rgb_dev.shape[0]), gal_names, time.perf_counter()

    def fetch(self, handle):
        """Wait for a submit() handle and return host-side results."""
        out, b, gal_names, t_submit = handle
        out = unpack_packed(out.cpu().numpy())
        out["gallery_names"] = gal_names
        self._record(b, out["count"], time.perf_counter() - t_submit)
        return out
