"""The plain reference of the recognition pipeline: camera frames in, every
face's box, landmarks, score, spoof probability and gallery distances out.

    BGR 1080p frame
      -> letterbox to the detector's square: bilinear at pixel centres,
         BT.601 studio-swing I420 (chroma at the even rows and columns),
         decoded back to RGB with nearest chroma, dead rows black
      -> RetinaFace, priors, decode, top-K by score, greedy suppression at
         max(IoU / iou_t, IoM / iom_t) > 1, the first M kept
      -> a least-squares similarity of the 5 landmarks onto ArcFace's 112 x
         112 template, bilinear crops at output pixel centres
      -> the embedder (unit norm, times the distance scale) and the spoof
         net's softmax; euclidean distances to every gallery entry

Float32 throughout (TF32 off on the card). It reads its weights from the
files the harness hands out and imports nothing of the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import embedders, nets
from perfbench.reference.precision import ROUNDING

ARCFACE_112 = np.array([[38.2946, 51.6963], [73.5318, 51.5014], [56.0252, 71.7366],
                        [41.5493, 92.3655], [70.7299, 92.2041]], np.float32)
PRIOR_SIZES = ((16, 32), (64, 128), (256, 512))
PRIOR_STEPS = (8, 16, 32)
VARIANCES = (0.1, 0.2)


def load_npz(path: str, device) -> dict:
    """A weights file of flat ``a/b/0/w`` keys (``#none`` marks an absent
    unit) -> the nested tree of float32 tensors; integer keys make lists."""
    root: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = root
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            last = parts[-1]
            if last.endswith("#none"):
                node[last[: -len("#none")]] = None
            else:
                node[last] = torch.from_numpy(np.asarray(data[key], np.float32)).to(device)

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return lists(root)


# -- letterbox ----------------------------------------------------------------

def letterbox_i420(bgr: np.ndarray, size: int, rows: int) -> np.ndarray:
    """[H, W, 3] uint8 BGR -> [rows * 3 / 2, size] uint8 I420 of the frame
    scaled uniformly into a rows x size canvas, centred, black around it."""
    h, w = bgr.shape[:2]
    s = min(size / w, rows / h)
    nw, nh = max(1, int(round(w * s))), max(1, int(round(h * s)))

    def taps(n, limit):
        c = np.clip((np.arange(n) + 0.5) / s - 0.5, 0.0, limit - 1)
        i0 = np.floor(c).astype(np.int64)
        return i0, np.minimum(i0 + 1, limit - 1), c - i0

    y0, y1, wy = taps(nh, h)
    x0, x1, wx = taps(nw, w)
    wx3, wy3 = wx[None, :, None], wy[:, None, None]

    def tap(ys, xs):
        return bgr[ys][:, xs].astype(np.float64)

    top = tap(y0, x0) * (1 - wx3) + tap(y0, x1) * wx3
    bot = tap(y1, x0) * (1 - wx3) + tap(y1, x1) * wx3
    img = np.zeros((rows, size, 3), np.int64)
    ox, oy = (size - nw) // 2, (rows - nh) // 2
    img[oy:oy + nh, ox:ox + nw] = np.floor(top * (1 - wy3) + bot * wy3 + 0.5).astype(np.int64)
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    # BT.601 studio swing in 20-bit fixed point: Y = 0.257 R + 0.504 G +
    # 0.098 B + 16, U = -0.148 R - 0.291 G + 0.439 B + 128, V = 0.439 R -
    # 0.368 G - 0.071 B + 128, rounded half up
    one, half = 20, 1 << 19
    yp = (269484 * r + 528482 * g + 102760 * b + (16 << one) + half) >> one
    cb, cg, cr = b[::2, ::2], g[::2, ::2], r[::2, ::2]
    up = (-155188 * cr - 305135 * cg + 460324 * cb + (128 << one) + half) >> one
    vp = (460324 * cr - 385875 * cg - 74448 * cb + (128 << one) + half) >> one
    out = np.concatenate([yp.reshape(-1), up.reshape(-1), vp.reshape(-1)])
    return np.clip(out, 0, 255).astype(np.uint8).reshape(rows * 3 // 2, size)


def i420_to_rgb(yuv: torch.Tensor, size: int) -> torch.Tensor:
    """[B, rows * 3 / 2, size] uint8 I420 -> [B, size, size, 3] uint8 RGB:
    BT.601 studio swing, chroma repeated 2 x 2, values truncated, the rows
    outside the active ones black."""
    b, r15, w = yuv.shape
    rows = r15 * 2 // 3
    y = yuv[:, :rows].float()
    q = rows // 4
    u = yuv[:, rows:rows + q].reshape(b, rows // 2, w // 2).float() - 128.0
    v = yuv[:, rows + q:].reshape(b, rows // 2, w // 2).float() - 128.0
    u = u.repeat_interleave(2, 1).repeat_interleave(2, 2)
    v = v.repeat_interleave(2, 1).repeat_interleave(2, 2)
    yl = 1.164 * (y - 16.0)
    rgb = torch.stack([yl + 1.596 * v, yl - 0.392 * u - 0.813 * v, yl + 2.017 * u], -1)
    rgb = torch.clamp(rgb, 0.0, 255.0).to(torch.uint8)
    out = torch.zeros((b, size, size, 3), dtype=torch.uint8, device=yuv.device)
    top = (size - rows) // 2
    out[:, top:top + rows] = rgb
    return out


# -- detection ----------------------------------------------------------------

def priors(size: int, device) -> torch.Tensor:
    """[A, 4] (cx, cy, w, h) in units of the image, by stride, row, column
    and anchor of a cell."""
    out = []
    for step, sizes in zip(PRIOR_STEPS, PRIOR_SIZES):
        fm = math.ceil(size / step)
        for i in range(fm):
            for j in range(fm):
                for m in sizes:
                    out.append(((j + 0.5) * step / size, (i + 0.5) * step / size,
                                m / size, m / size))
    return torch.tensor(out, dtype=torch.float32, device=device)


def detect(p, rgb: torch.Tensor, pri: torch.Tensor, cfg: dict, q) -> list:
    """uint8 RGB [B, S, S, 3] -> a list a frame of (boxes [n, 4] xyxy px,
    landmarks [n, 10] px, scores [n]) of the kept faces in rank order."""
    size = rgb.shape[1]
    x = (rgb.float() - 127.5) / 128.0
    loc, ldm, score = nets.retinaface(p, x, q)
    v0, v1 = VARIANCES
    k = min(cfg["pre_nms_topk"], score.shape[1])
    out = []
    for f in range(rgb.shape[0]):
        order = torch.argsort(-score[f], stable=True)[:k]
        pr, lo, ld, sc = pri[order], loc[f, order], ldm[f, order], score[f, order]
        cxy = pr[:, :2] + lo[:, :2] * v0 * pr[:, 2:]
        wh = pr[:, 2:] * torch.exp(lo[:, 2:] * v1)
        boxes = torch.cat([cxy - wh / 2, cxy + wh / 2], -1) * size
        lms = (pr[:, None, :2] + ld.reshape(-1, 5, 2) * v0 * pr[:, None, 2:]).reshape(-1, 10) * size
        keep = _greedy(boxes.double().cpu().numpy(), sc.double().cpu().numpy(), cfg)
        keep = keep[: cfg["max_faces"]]
        out.append((boxes[keep], lms[keep], sc[keep]))
    return out


def _greedy(boxes: np.ndarray, scores: np.ndarray, cfg: dict) -> list:
    """Ranks kept by greedy suppression: a candidate above the score
    threshold is kept unless a kept higher-ranked one overlaps it by more
    than max(IoU / iou_t, IoM / iom_t) > 1."""
    x1, y1, x2, y2 = boxes.T
    area = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    kept: list = []
    for i in range(len(scores)):
        if scores[i] < cfg["conf_thresh"]:
            continue
        ok = True
        for j in kept:
            iw = max(0.0, min(x2[i], x2[j]) - max(x1[i], x1[j]))
            ih = max(0.0, min(y2[i], y2[j]) - max(y1[i], y1[j]))
            inter = iw * ih
            iou = inter / max(area[i] + area[j] - inter, 1e-12)
            iom = inter / max(min(area[i], area[j]), 1e-12)
            if max(iou / cfg["iou_thresh"], iom / cfg["iom_thresh"]) > 1.0:
                ok = False
                break
        if ok:
            kept.append(i)
    return kept


# -- crops, embeddings, spoof, match -----------------------------------------

def similarity(src: torch.Tensor) -> torch.Tensor:
    """Least-squares similarity [n, 2, 3] taking landmarks [n, 5, 2] onto the
    ArcFace template (rotation, uniform scale, translation)."""
    dst = torch.as_tensor(ARCFACE_112, device=src.device).expand_as(src)
    ms, md = src.mean(1, keepdim=True), dst.mean(1, keepdim=True)
    sc, dc = src - ms, dst - md
    var = torch.clamp((sc * sc).sum((1, 2)), min=1e-12)
    a = (sc * dc).sum((1, 2)) / var
    b = (sc[..., 0] * dc[..., 1] - sc[..., 1] * dc[..., 0]).sum(1) / var
    tx = md[:, 0, 0] - (a * ms[:, 0, 0] - b * ms[:, 0, 1])
    ty = md[:, 0, 1] - (b * ms[:, 0, 0] + a * ms[:, 0, 1])
    return torch.stack([torch.stack([a, -b, tx], -1), torch.stack([b, a, ty], -1)], -2)


def crops(frame: torch.Tensor, lms: torch.Tensor, out: int = 112) -> torch.Tensor:
    """uint8 RGB frame [H, W, 3], landmarks [n, 10] -> [n, out, out, 3]
    float crops: each output pixel centre mapped back through the inverse
    similarity, clamped to the frame, sampled bilinearly."""
    n = lms.shape[0]
    if n == 0:
        return torch.zeros((0, out, out, 3), device=frame.device)
    m = similarity(lms.reshape(n, 5, 2).float())
    a, b = m[:, 0, 0], m[:, 1, 0]
    det = torch.clamp(a * a + b * b, min=1e-12)
    ia, ib = a / det, -b / det
    tx, ty = m[:, 0, 2], m[:, 1, 2]
    itx, ity = -(ia * tx - ib * ty), -(ib * tx + ia * ty)
    g = torch.arange(out, dtype=torch.float32, device=frame.device) + 0.5
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    sx = ia[:, None, None] * gx - ib[:, None, None] * gy + itx[:, None, None] - 0.5
    sy = ib[:, None, None] * gx + ia[:, None, None] * gy + ity[:, None, None] - 0.5
    h, w = frame.shape[:2]
    sx = torch.clamp(sx, 0.0, w - 1.0)
    sy = torch.clamp(sy, 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(sx).long(), max=w - 2)
    y0 = torch.clamp(torch.floor(sy).long(), max=h - 2)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    f = frame.float()
    top = f[y0, x0] * (1 - wx) + f[y0, x0 + 1] * wx
    bot = f[y0 + 1, x0] * (1 - wx) + f[y0 + 1, x0 + 1] * wx
    return top * (1 - wy) + bot * wy


IMAGENET_MEAN = (0.485 * 255, 0.456 * 255, 0.406 * 255)
IMAGENET_STD = (0.229 * 255, 0.224 * 255, 0.225 * 255)


class Reference:
    """The models of one configuration, loaded from the weights directory
    the harness made, in float32 on ``device``; ``precision`` "fp8" makes
    it the control."""

    def __init__(self, cfg: dict, weights_dir: str, device, precision: str = "float32"):
        self.cfg, self.device = cfg, device
        self.q = ROUNDING[precision]
        files = cfg["weights"]
        self.det = load_npz(f"{weights_dir}/{files['detector']}", device)
        self.emb = load_npz(f"{weights_dir}/{files['embedder']}", device)
        self.spoof = load_npz(f"{weights_dir}/{files['spoof']}", device)
        self.embed_fn = embedders.resolve(cfg["embedder_arch"]).forward
        self.priors = priors(cfg["det_size"], device)

    @torch.no_grad()
    def faces(self, yuv: np.ndarray, gallery: np.ndarray, landmarks: list | None = None,
              block: int = 64) -> list:
        """I420 frames [B, rows * 3 / 2, S] -> a list a frame of dicts of
        numpy arrays: boxes, landmarks, scores, fake_prob, embeddings [n, D]
        (unit norm) and distances [n, N] to the gallery [N, D]. With
        ``landmarks`` (a frame's [m, 10] px of the faces of the results
        being judged), also ``judged``: the fake_prob [m] and distances
        [m, N] of the crops cut at those landmarks, so that the embedder and
        the spoof net are judged on the crops they were given."""
        cfg = self.cfg
        rgb = i420_to_rgb(torch.from_numpy(np.ascontiguousarray(yuv)).to(self.device),
                          cfg["det_size"])
        dets = []
        for i in range(0, rgb.shape[0], 8):
            dets += detect(self.det, rgb[i:i + 8], self.priors, cfg, self.q)
        gal = torch.from_numpy(np.asarray(gallery, np.float64)).to(self.device)
        out = []
        for f, (boxes, lms, scores) in enumerate(dets):
            unit, fake, dist = self._describe(rgb[f], lms, gal, block)
            out.append({
                "boxes": boxes.cpu().numpy(), "landmarks": lms.cpu().numpy(),
                "scores": scores.cpu().numpy(), "fake_prob": fake.cpu().numpy(),
                "embeddings": unit.cpu().numpy(), "distances": dist.cpu().numpy(),
            })
            if landmarks is not None:
                at = torch.as_tensor(np.asarray(landmarks[f], np.float32).reshape(-1, 10),
                                     device=self.device)
                _, fake, dist = self._describe(rgb[f], at, gal, block)
                out[-1]["judged"] = {"fake_prob": fake.cpu().numpy(),
                                     "distances": dist.cpu().numpy()}
        return out

    def _describe(self, frame, lms, gal, block: int):
        """The unit embeddings, spoof probabilities and gallery distances of
        the crops of ``frame`` cut at ``lms`` [n, 10]."""
        cfg, q = self.cfg, self.q
        mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        std = torch.tensor(IMAGENET_STD, device=self.device)
        cr = crops(frame, lms)
        embs, fakes = [], []
        for i in range(0, cr.shape[0], block):
            c = cr[i:i + block]
            embs.append(self.embed_fn(self.emb, (c - 127.5) / 128.0, q))
            logits = nets.mobilenetv3(self.spoof, (c - mean) / std, q)
            fakes.append(torch.softmax(logits, -1)[:, 1])
        d = cfg["embed_dim"]
        unit = (torch.cat(embs) if embs else torch.zeros((0, d), device=self.device)).double()
        emb = unit * cfg["distance_scale"]
        dist = torch.cdist(emb, gal) if emb.shape[0] else emb.new_zeros((0, gal.shape[0]))
        fake = torch.cat(fakes) if fakes else torch.zeros(0)
        return unit, fake, dist
