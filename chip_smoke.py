"""Smoke run of the PyTorch port (``frp_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on its own lines, in order:

1. device   the card's name, and its name and power limit from nvidia-smi.
2. build    nvcc builds the five kernels of ``frp_tpu_torch/csrc`` for
            sm_90a, all at once.
3. kernels  each kernel against its plain PyTorch version on the card at the
            main path's shapes: masks, valid flags and counts bit for bit,
            floats within 1e-3. Each gets its median time over 50 launches
            (CUDA events), its bound, the plain version's time and, for the
            warp, the time of F.grid_sample (a yardstick the port never calls).
            The detection head is held and timed on two inputs: 64 of 256
            candidates above the score threshold, and all 256 above in a
            crowd of overlapping boxes. The warp is also held on faces far
            larger than the frame. The greedy kernel is held and timed at
            K=256, 512 and 1024 with 60 % of the candidates above, and at
            K=512 with all above in a crowd and with 10 % above; a whole
            nms_padded_batched call over the 16800 anchors is timed beside
            the kernel's share of it. The chains' pass (bn_act, which
            replaces no TPU kernel) at r50.stream's rung of 1664 faces,
            bf16, in each of its seven modes where iresnet50 runs it
            (``BN_ACT_CASES``: the stem's BN-PReLU with block 0's bn1 at
            64 x 112 x 112, block 0's pass A into conv2's padded input,
            pass A and the BN-add-BN pass B with the block input and with
            the down shortcut at stage 1 and stage 3, the last block's
            head_bn alone), and at the cells' 128 frames at det 640 in the
            detector's modes (BN and leaky ReLU after the stem, into a
            stride-2 depthwise conv's padded input, at stage 2 and 3 and
            an SSH conv; BN and PReLU into a padded input, as a real det
            export runs it): each output within 1 bf16 ulp of its chain
            computed in f32 and rounded once (the plain version), timed
            beside it, beside its bound (bytes over 3.35 TB/s) and beside
            the eager bf16 chain it replaced. Phases 4, 8, 13 and 18 print
            its launches and hold them on the card to exactly 1 + 2 x blocks
            for each inference forward of an iresnet that the phase ran (17
            for iresnet18, 49 for iresnet50; none for MobileFaceNet), plus
            38 for each inference forward of the detector, counted by
            wrappers of ``iresnet_forward`` and ``retinaface_forward`` apart
            from the pass.
            The add-LN pass (add_ln, which replaces no TPU kernel either)
            at the embed rung of 1664 faces, bf16, at each shape the cells
            run it (``ADD_LN_CASES``): the ViT-L's [1664 x 144, 768] in its
            two kinds of site, a block's add with the LN after it (r and
            LN(r) written) and the last add with the float32 final LN
            (LN(r) alone), and the Swin-T's four residual streams
            [1664 x 3136, 96], [1664 x 784, 192], [1664 x 196, 384] and
            [1664 x 49, 768], a block's add, and its last add at
            [1664 x 49, 768]: r equal to x + d rounded once, LN(r) equal to
            the kernel's arithmetic in f32 rounded once (0 ulps; the plain
            version ``add_ln_f32``, the same sums in the same order), timed
            beside it, beside its bound (bytes over 3.35 TB/s) and beside
            the eager add and LN it replaced.
4. engine   the port's RecognitionEngine on cuda in the default profile (det
            640, 16 slots, top-256, bf16, spoof and quality on, MobileFaceNet,
            the shipped weights) over a DeltaEncoder stream of 8 rendered 640
            scenes: one keyframe and 20 delta ticks that move a patch in each
            frame, then an enrolment with encode_image and one more scan.
            Checks the launch counts, the resident batch against
            DeltaEncoder.apply_host, the detections and the enrolled match;
            prints frames/s, faces/s, submit_encoded's host ms, the host
            syncs of each of 5 steady batches' submit and fetch (torch's sync
            debug mode, and the synchronizing CUDA calls inside the engine's
            frp.submit_encoded and frp.fetch_many spans), their per-stage
            device ms (the engine's stage spans under torch.profiler) and the
            embed stage's rung counts (speculated, redone in a fetch, whole,
            slots embedded).
5. nms      an engine with pre_nms_topk=512, whose detect stage goes through
            decode + nms_padded_batched and so launches the greedy kernel.
6. parity   the engine at f32 (TF32 off) on cuda and on the CPU over 2
            frames: valid, count and best_idx bit for bit, boxes within
            1e-2 px. With the CPU tests against the JAX package, this chains
            the card's results back to the reference.

7. fused    build_pipeline, the single-program entry point, on cuda at the
            default profile's width over the 8 rendered scenes as uint8 RGB
            and the gallery of phase 4: a call launches the greedy kernel and
            the warp once each and never the fused head; its result is held
            against the staged engine's process_frames on the same frames
            (valid, count, best_idx bit for bit, boxes within 1e-2 px,
            embeddings and fake_prob within 2e-2); the enrolled face
            matches; prints ms a call over 20 calls.

8. accuracy the accuracy profile (iresnet18 + flip-TTA, its flip-mode
            calibration, the rest as phase 4) over phase 4's stream and
            enrolment, with phase 4's checks and numbers. Then the same
            engine built with FRP_EMBED_COMPACT=0 on the same batch: valid,
            count and best_idx bit for bit, embeddings and fake_prob within
            2e-2; the ms a batch of two short streams each with compaction on
            and off, in turns, the embed stage's device ms of each stream run
            again under torch.profiler (its span), beside its bound (the stage's
            matmul and conv FLOPs, as utils/flops.py counts them,
            over the bf16 peak), and the device-busy ms a batch of one more
            stream each from a torch.profiler trace. The same for the default
            profile on phase 4's engine. Last, phase 6's parity for this
            profile at 4 slots a frame.
9. pipelined a fresh default-profile engine over phase 4's stream, submitted
            then fetched one batch at a time; precompile_delta_rungs (one
            no-op payload a ladder rung, the resident batch unchanged); then
            the same payloads uploaded by put_payload on a second thread,
            submitted on this one and fetched with fetch_many in groups of 4,
            twice, and once more submitted then fetched: every pass equals
            the first (integer and mask columns bit for bit, floats within
            1e-3). Prints each pass's frames/s and ms/batch.
10. platform the port's serving platform as a user runs it: AppContext on the
            card with the default config (det 640, 16 slots, bf16, delta
            transfer on), 8 synthetic 1920x1080 cameras and a temporary data
            dir. One dry run_scan warms it up; camera 0's face is enrolled
            through FaceService.encode_image and store_face; the port's
            HTTPServer listens on 127.0.0.1:0 and a Socket.IO client
            connects; 20 GET /camera/alerts follow over the socket, each a
            scan (letterbox, delta payload, engine, tracking, alerts). Checks:
            every scan scanned 8 cameras and found faces, the enrolled face
            matched on camera 0 below the tolerance every time, alerts and
            tracking records landed in the store and new_alert reached the
            socket, delta_stats shows deltas and no desync, kernels 1 and 2
            launched once a scan. Prints ms a scan on the host clock (and its
            parts, from the scan's stage timers), the delta payload's size,
            scans/s and frames/s, and the device ms a scan and a stage of 5
            more (dry) scans under torch.profiler (every thread). Then
            the same cameras through a cuda and a cpu context, both at f32
            (TF32 off), 2 scans each: the same targets and cameras, valid,
            count and best_idx bit for bit, boxes within 1e-2 px. Also the
            scans' submit ms, the embed stage's rung counts, and the host
            syncs of one more (dry) scan.
11. services the rest of the platform on phase 10's app (a new one: the
            default config, the 8 cameras), served over the socket: POST
            /deepfake/detect with a 1920x1080 MJPG clip of 60 frames, one
            moving rendered face, gone from 10 of them (a 12-frame clip
            first warms the chunk shapes up): 20 sampled, frames with a face
            as rendered, kernels 1 and 2 once a chunk (8, 8, 4); the same
            bytes again are served from the cache with no launch; POST
            /deepfake/detect-image; GET /deepfake/cctv?max_frames=3; POST
            /async/face/search with camera 0's enrolled frame, polled until
            it names the enrolled face; two FL clients and the aggregate,
            equal to the numpy mean bit for bit; the snapshot (200 with an
            ETag, then 304), /app and /dashboard. Prints the video's ms on
            the host clock (read and seek, letterbox, engine), the device ms
            a chunk (the video's chunks again, under torch.profiler), ms a
            sampled frame, the CCTV sweep's ms, and the ms to
            read the sampled frames by seeking with cv2's MJPEG backend and
            the whole clip in order with the default one (the service's
            seeks must give the in-order read's frames bit for bit). Then the
            video at f32 (TF32 off) on cuda and on the CPU: every sampled
            frame's face count, fake_prob within 1e-3, boxes within 1e-2 px,
            the same verdict. Last, the default bf16 engine on cuda against
            the CPU engine at bf16 on the rendered scenes and the sampled
            frames: valid and count equal; a face agrees when its box is
            within 1 px, its embedding at cosine >= 0.99 and its fake_prob
            within 0.02; every face whose kept anchor is the same on both
            must agree, and one whose kept anchor differs must be a near tie
            (the two anchors' CPU scores within 2e-4: bf16 rounding flips
            which one greedy suppression keeps) with fake_prob within 0.02;
            best_idx equal on agreeing faces where the CPU's two nearest
            entries are 0.05 apart; no per-frame verdict flips. The counts
            of each are printed.

12. train  the port's trainers on the card at full width, bf16, one fixed
            batch rendered once before timing (its host ms printed), 20
            steps, the loss falling: ArcFace with MobileFaceNet and with
            iresnet18 (128-d; 64 identities, batch 64, lr 0.05, margin 0.5:
            tools/pretrain_embedder.py's defaults), iresnet18 again at batch
            256, the spoof trainer (batch 64 of pretrain_spoof's crops) and
            the detector trainer (det 320, batch 16, make_batch "mix"). Each
            prints its step ms (median after 3 warm steps, CUDA events and
            the synchronized host clock), images/s, FLOPs a step
            (utils/flops.py, forward and backward), its bound (the larger of
            the FLOPs over 989 TFLOP/s bf16 and the bytes over 3.35 TB/s) and
            its share of it, the device-busy ms and idle share from a
            torch.profiler trace, and the peak memory. Then one step of each
            trainer at f32 (TF32 off) on cuda and on the CPU from the same
            seed (train_parity's bounds); the trained MobileFaceNet, written
            by save_params beside the shipped detector and spoof weights,
            served by an engine over the 8 scenes (valid and count equal to
            phase 4's engine, kernels 1 and 2 once) and by
            train.pairs.embed_scenes; and two fl_client runs (5 steps each)
            uploading their weights_delta to the port's server, the aggregate
            equal to the numpy mean of the two deltas bit for bit under the
            JAX package's layer names.

13. imported a site's own weights: a seeded w600k-style embedder.onnx
            (iresnet50, 512-d, BN folded, numeric names shuffled, float32
            raw_data) beside the shipped detector and spoof npz
            ("mixed"), and with retinaface.onnx and spoof.onnx written from
            the shipped npz ("onnx"). On the card, as child processes all at
            once: import_real_weights --dry-run on the detector and spoof
            exports (passes) and on the 512-d embedder (refused: embedders
            are validated at 128-d, as the JAX tool does), calibrate_embedder
            and tiered_eval over the mixed dir at 3 identities x 2 variants
            (their defaults 24 x 6 and 20 x 4 cut), each with its wall time.
            Meanwhile: both engines (iresnet50, 512-d, the rest as phase 4) at
            f32 on cuda and on the CPU (phase 6's check, 4 slots, on scenes 5 and
            6, which hold two faces each), the mixed
            one at bf16 against the CPU at bf16 (phase 11's rule). Then (a)
            the mixed engine over phase 4's stream with phase 4's checks and
            numbers ("same" padding kept, scale 1.0), its compaction on
            against off with the embed stage's FLOPs, bound and device-busy
            share (phase 8's runs), and (b) the all-ONNX engine ("torch"
            padding) over the same stream. Kernels 1 and 2 launch once a
            batch; the padding mode is "same" again afterwards.

14. mesh     (a) the engine over a mesh of the card repeated twice (data 2):
            the default profile over phase 4's stream, 4 frames a shard;
            kernels 1 and 2 launch once a shard a batch; ms/batch and the
            host syncs of a steady batch's submit and fetch beside an
            unsharded engine's; against the unsharded engine at bf16 by
            phase 11's NEAR_TIE rule and at f32 (TF32 off) bit for bit in
            valid, count and best_idx, boxes within 1e-2 px, also at B=1
            and B=3, which the data axis does not divide (RGB frames, a
            keyframe and a delta). (b) four gloo
            processes share the card as a 2 x 2 process mesh: the
            MobileFaceNet ArcFace (dp x tp), spoof and detector (dp) f32
            steps against one process on the card (train_parity's bounds),
            and the bf16 ArcFace step at phase 12's batch, its ms a step
            against phase 12's. (c) a one-rank NCCL group (no collective in
            its step) runs the f32 ArcFace step against one process, and
            the bf16 step beside the same step without a mesh. (d) the FL
            service over the
            mesh of (a) aggregates two clients: backend mesh_psum[2], the
            f32 mean bit for bit.

15. host     (a) the port's host library: g++ builds csrc/framepack.cpp at
            its first use (the path is printed); on 8 frames of 1920x1080
            it is held bit for bit against its numpy versions (the letterbox
            packer, the delta block search, count and fill, and the band
            detector with its updated previous frame), ms of each printed.
            (b) the scan over cameras without change hints: AppContext with
            the default config and 8 PushSource 1920x1080 cameras fed 16
            ticks of phase 10's motion rendered first (camera 3 static,
            camera 5 cut to another scene at tick 8), a run_scan a tick:
            every batch rebuilt from the payloads equals build_batch_i420 of
            its frames, faces found and camera 0's enrolled face matched
            every scan, deltas without a desync, kernels 1 and 2 once a scan,
            the static slot's delta hint [] and the others' block ranges;
            the letterbox ms a scan (the change detector and the banded
            letterbox) against build_batch_i420 on the same frames, payload
            bytes and scans/s. Then a synthetic camera that a probe reads
            between scans, its hints and the detector mixed: every cached
            batch equals a full letterbox. (c) build_pipeline with spoof
            off, quality off and 224 px spoof crops, and the engine with
            spoof off, at f32 (TF32 off) on cuda and on the CPU over phase
            6's frames (phase 6's check; the outputs switched off absent).
            (d) engine_stage_flops of phase 4's and phase 8's engines at the
            faces a batch those phases found, and the MFU over phase 8's
            device-busy ms and over each phase's ms/batch.

16. entry    the twin of __graft_entry__.entry() (frp_tpu_torch/testing/
            entry.py): fn(*example_args) on the card, build_pipeline at det
            320, 8 slots, top-128, bf16, the seeded random nets on two noise
            frames and a 128 x 128 gallery: one call launches the warp and
            the greedy kernel at K=128 once each; 14 results, finite; ms a
            call over 20 calls. The same forward at f32 (TF32 off) on the
            card and on the CPU: valid and count bit for bit, boxes within
            1e-2 px. Kernels 2 and 3 on the inputs that call gave them,
            against their plain versions and timed as phase 3 times them.

17. bench    the port's bench entry point: one attempt, ``python -m
            frp_tpu_torch.bench --once`` as a child process with
            BENCH_WINDOWS=1 and BENCH_TICKS=2 (8 synthetic 1080p cameras,
            12 faces a frame, 16 frames a submission, depth 24, groups of 12,
            a producer and a transfer thread, delta transfer), under a
            timeout. Its JSON line's fields are printed; it must have found
            all 192 faces of a batch (or, where the card finds fewer, as many
            as the port's f32 engine finds in the same batch), held the
            window's resident batch equal to the producer's last batch bit
            for bit, and launched kernels 1 and 2 once a batch.

18. diagnostics the accuracy diagnostics, the twins of
            tools/diagnose_e2e_gap.py and tools/prototype_flip_tta.py: each
            tool's main(argv) in this process at iresnet18, 3 identities x 2
            variants (their defaults 20 x 4 cut; the diagnosis at tier 2,
            the prototype over tiers 0-3), on the card at f32 (TF32 off),
            on the card at the default bf16, and on the CPU at f32. Each card
            run launches kernels 1 and 2 once an engine batch (the diagnosis
            1, the prototype 8) and kernel 3 never. The f32 card run equals
            the CPU run in every count (scenes, detected, common, n_same,
            n_diff), the landmark error within 0.05 px, AUC, EER and
            medians within 1e-4, and each TPR and FPR exactly unless a pair
            distance lies within 1e-4 of its threshold (those are printed).
            Prints each run's wall s, launches and report; the bf16 run is
            reported beside the f32 one, not held against it.

Every count of kernel launches is set to 0 just before phases 4, 5, 7, 8, 9,
10, 11, 12, 13, 14, 15 (b) and (c) and 16 and each run of phase 18 and read
just after; phase 17's are the child's own, from its start to its end. Any failed check raises, so the run exits
non-zero. The line before the last is one JSON object with every kernel's
numbers; the last line is {"ok": true, "device": {"platform": "gpu", "kind":
..., "count": 1}}. Where torch.cuda.is_available() is false it exits non-zero
and prints no result.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import importlib
import io
import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from frp_tpu_torch.api.http import HTTPServer
from frp_tpu_torch.api.main import build_app
from frp_tpu_torch.api.socketio import read_frame
from frp_tpu_torch.config import load_config
from frp_tpu_torch.engine import batching, pipeline
from frp_tpu_torch.engine.batching import DeltaEncoder
from frp_tpu_torch.engine.pipeline import RecognitionEngine, build_pipeline, embed_compact_rungs
from frp_tpu_torch.models import iresnet, nn, retinaface
from frp_tpu_torch.ops import (add_ln_cuda, align_cuda, bn_act_cuda, cuda_build, detection_cuda,
                               kernels, nms_cuda)
from frp_tpu_torch.ops import reset_launches as reset_all_launches
from frp_tpu_torch.ops.align import invert_similarity
from frp_tpu_torch.ops.anchors import generate_anchors
from frp_tpu_torch.ops.decode import decode_boxes, decode_landmarks
from frp_tpu_torch.ops.nms import nms_padded_batched, overlap_matrix
from frp_tpu_torch.ops.topk import top_k
from frp_tpu_torch.platform.context import AppContext
from frp_tpu_torch.platform.state import SyntheticSource
from frp_tpu_torch.testing.payloads import crowd_payload
from frp_tpu_torch.testing.synthetic import make_scene, write_face_clip
from frp_tpu_torch.utils.flops import PEAK_FLOPS_BF16, counted_flops, engine_stage_flops, mfu
from frp_tpu_torch.utils.profiling import all_threads, busy_ms, gpu_name_and_limit

# H100 SXM published peaks (NVIDIA's data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores

PROFILE = dict(det_size=640, max_faces_per_frame=16, pre_nms_topk=256,
               compute_dtype="bfloat16", embedder_arch="mobilefacenet",
               embed_flip_tta=False)
ACCURACY = {**PROFILE, "embedder_arch": "iresnet18", "embed_flip_tta": True}
ACCURACY_SCALE = 0.81303  # weights/calibration_iresnet18_flip.json
FRAMES = 8
TICKS = 20  # delta ticks after the keyframe
SYNC_BATCHES = 5  # phase 4's steady batches under the sync count
WARM = 3  # ticks left out of the steady-state window
SEED = 0
ATOL = 1e-3


def launches() -> dict[str, int]:
    """The launch counts since the last reset_launches of the kernels that
    replace a TPU kernel (their declarations' ``replaces``); the chains'
    pass is counted apart, by ``chain_launches``."""
    return {name: k.launches for name, k in kernels().items() if k.replaces}


# the pass's launches owed by the inference forwards run on the card since
# the last reset_launches (1 + 2 x blocks an iresnet forward, 38 a
# detector's), and those forwards, counted where the engine and the tools
# look the forwards up, apart from the pass itself
_owed = {"launches": 0, "iresnet": 0, "detector": 0}
_owed_lock = threading.Lock()


def _owe(model: str, launches: int) -> None:
    with _owed_lock:
        _owed["launches"] += launches
        _owed[model] += 1


def count_forwards() -> None:
    """Wrap ``iresnet_forward`` and ``retinaface_forward`` in their modules
    and in the engine's, its arch table ``EMBEDDERS`` included (before any
    engine is built), so that each inference forward of a CUDA input adds
    the launches it owes to ``_owed``; a training forward, or one autograd
    records, owes none."""
    base_iresnet, base_detector = iresnet.iresnet_forward, retinaface.retinaface_forward

    def counted_iresnet(params, x, normalize=True, train=False, bn_group=None):
        if x.is_cuda and not train:
            _owe("iresnet", 1 + 2 * sum(len(stage) for stage in params["stages"]))
        return base_iresnet(params, x, normalize, train, bn_group)

    def counted_detector(params, x):
        if x.is_cuda and not nn.records_grad(params, x):
            # the stem, two a depthwise-separable pair, the FPN's convs, two an SSH
            _owe("detector", 1 + 2 * sum(len(params[s]) for s in ("stage1", "stage2", "stage3"))
                 + len(params["fpn_lat"]) + len(params["fpn_td"]) + 2 * len(params["ssh"]))
        return base_detector(params, x)

    iresnet.iresnet_forward = pipeline.iresnet_forward = counted_iresnet
    retinaface.retinaface_forward = pipeline.retinaface_forward = counted_detector
    for arch, (init, forward) in pipeline.EMBEDDERS.items():
        if forward is base_iresnet:
            pipeline.EMBEDDERS[arch] = (init, counted_iresnet)


def reset_launches() -> None:
    """Clear every wrapper's launch count and the launches owed."""
    reset_all_launches()
    with _owed_lock:
        _owed.update(launches=0, iresnet=0, detector=0)


def chain_launches(dev) -> dict:
    """bn_act's launches since the last reset_launches, and the iresnet and
    detector inference forwards counted since. On the card, exactly the
    launches those forwards owe: a forward that took the eager path leaves
    them short."""
    n = bn_act_cuda.KERNEL.launches
    with _owed_lock:
        owed = dict(_owed)
    if dev.type == "cuda" and n != owed["launches"]:
        raise AssertionError(f"bn_act launched {n} times; the {owed['iresnet']} iresnet and "
                             f"{owed['detector']} detector forwards on the card owe "
                             f"{owed['launches']}")
    return {**owed, "launches": n}


def chain_text(c: dict, embedder: str) -> str:
    """A phase's bn_act launches (``chain_launches``) beside the forwards
    that owe them."""
    return f"{c['launches']} ({c['detector']} detector forwards of 38, {c['iresnet']} {embedder})"


def say(phase: str, text: str) -> None:
    print(f"[{phase}] {text}", flush=True)


# --- inputs ------------------------------------------------------------------

def rgb_to_i420(rgb: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 RGB -> [H*3//2, W] uint8 I420: BT.601 studio swing and
    the plane layout of cv2's COLOR_BGR2YUV_I420, chroma as the 2x2 mean."""
    f = rgb.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 16.0 + 0.257 * r + 0.504 * g + 0.098 * b
    u = 128.0 - 0.148 * r - 0.291 * g + 0.439 * b
    v = 128.0 + 0.439 * r - 0.368 * g - 0.071 * b
    h, w = y.shape

    def q(c):
        return np.clip(np.rint(c), 0, 255).astype(np.uint8)

    def chroma(c):
        return q(c.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))).reshape(h // 4, w)

    return np.concatenate([q(y), chroma(u), chroma(v)], axis=0)


def render_scenes(n: int, size: int, seed: int) -> np.ndarray:
    """n rendered RGB scenes [n, size, size, 3]; every fourth one is a
    single-face portrait (the enrolment shape)."""
    return np.stack([
        make_scene(size, np.random.default_rng(seed + i), max_faces=3, portrait=i % 4 == 0)[0]
        for i in range(n)
    ])


def tick_batch(scenes: np.ndarray, t: int) -> np.ndarray:
    """The I420 batch of tick t: each frame's scene with a 40 px patch that
    moves 24 px a tick along its bottom band."""
    out = []
    for i, img in enumerate(scenes):
        img = img.copy()
        size = img.shape[0]
        x0 = (24 * t + 80 * i) % (size - 40)
        img[size - 48 : size - 8, x0 : x0 + 40] = (30 + 20 * i, 200, 255 - 25 * i)
        out.append(rgb_to_i420(img))
    return np.stack(out)


# --- measurement -------------------------------------------------------------

def device_ms(fn, reps: int = 50, host_bound: bool = False) -> float:
    """Median device time of one call of fn, in ms, from CUDA events around
    each of `reps` calls. A sleep kernel first holds the stream for tens of
    ms, long enough for the host to queue every call of a kernel, so the
    calls run back to back and each time is the device's, not the host's
    launch overhead; if the device drained the queue anyway, this raises.
    The plain versions issue hundreds of small ops a call and keep the
    device waiting on the host whatever the hold: `host_bound=True` takes
    their time as it comes."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(100_000_000)
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    if not host_bound and ev[reps].query():
        raise AssertionError("the device drained the queue before the host filled it: "
                             "the times would be the host's")
    torch.cuda.synchronize()
    return float(np.median([ev[i].elapsed_time(ev[i + 1]) for i in range(reps)]))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations"): the larger of the bytes
    over the memory rate and the operations over the f32 rate."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0


# --- phase 3: each kernel against its plain version --------------------------

HEAD_ARGS = (16, 0.5, 0.4, 0.5, 640.0)  # M, conf, iou, iom thresholds, det size


def random_head(dev, b=FRAMES, det=640):
    """Random head outputs (loc [B, A, 4], ldm [B, A, 10], scores [B, A]) over
    the 16800 anchors of det 640, 64 confident anchors a frame, and the
    anchors [A, 4]."""
    rng = np.random.default_rng(SEED)
    priors = torch.from_numpy(generate_anchors(det).copy()).to(dev)
    a = priors.shape[0]
    loc = rng.normal(0, 0.4, (b, a, 4)).astype(np.float32)
    ldm = rng.normal(0, 0.4, (b, a, 10)).astype(np.float32)
    scores = rng.uniform(0, 0.25, (b, a)).astype(np.float32)
    for i in range(b):
        scores[i, rng.choice(a, 64, replace=False)] = rng.uniform(0.5, 1.0, 64)
    return (*(torch.from_numpy(x).to(dev) for x in (loc, ldm, scores)), priors)


def head_payload(dev, crowd: bool, b=FRAMES, det=640, k=256) -> torch.Tensor:
    """Kernel 1's payload [B, K, 19] at B=8, K=256. The usual input: random
    head outputs over the 16800 anchors of det 640 with 64 confident anchors
    a frame, through the top-K. The crowd: all 256 candidates above the score
    threshold, their boxes scattered around four centres a frame, so that a
    large share of the pairs intersect (``testing/payloads.py``)."""
    if crowd:
        rng = np.random.default_rng(SEED + 7)
        return torch.from_numpy(crowd_payload(rng, b, k, n_above=k)).to(dev)
    loc, ldm, scores, priors = random_head(dev, b, det)
    return detection_cuda.build_payload(loc, ldm, scores, priors, k)


def check_detection_head(dev, crowd: bool = False) -> dict:
    """Kernel 1 at B=8, K=256, M=16 on one of its two inputs."""
    return hold_head(head_payload(dev, crowd), *HEAD_ARGS)


def hold_head(payload: torch.Tensor, *args) -> dict:
    """Kernel 1 on a payload [B, K, 19] and its arguments (M, conf, iou, iom
    thresholds, det size) against its plain version (valid slots equal,
    floats within ATOL), then its median time over 50 launches, its bound
    and the plain version's time."""
    b, k, _ = payload.shape
    got = detection_cuda.fused_head_kernel(payload, *args)
    want = detection_cuda.fused_head_plain(payload, *args)
    torch.cuda.synchronize()
    if not torch.equal(got[..., 15], want[..., 15]):
        raise AssertionError(f"detection_head {tuple(payload.shape)}: valid slots differ from "
                             "the plain version")
    err = max_err(got, want)
    if not err <= ATOL:
        raise AssertionError(f"detection_head {tuple(payload.shape)}: max abs err {err} > {ATOL}")
    m, conf, iou, iom, det = args
    above = payload[..., 18] >= conf
    boxes = decode_boxes(payload[..., 0:4], payload[..., 14:18], det)
    meet = torch.triu(overlap_matrix(boxes, iou, iom) > 0, 1)
    # per candidate pair j > i: 19 operations of the effective overlap and one
    # compare; per candidate about 70 of box and landmark decode. This is the
    # function's nominal work: the kernel skips the pairs the greedy pass
    # cannot read, so a share of this bound is no efficiency
    ops = b * k * (k - 1) / 2 * 20 + b * k * 70
    bms, by = bound(payload.numel() * 4 + got.numel() * 4, ops)
    return dict(
        shape=f"B={b} K={k} M={m}, {int(above.sum()) // b} above a frame, "
              f"{100 * float(meet.sum()) / (b * k * (k - 1) / 2):.1f} % of pairs intersect",
        max_abs_err=err,
        ms=device_ms(lambda: detection_cuda.fused_head_kernel(payload, *args)),
        plain_ms=device_ms(lambda: detection_cuda.fused_head_plain(payload, *args), 10, True),
        bound_ms=bms, bound_by=by, library_ms=None,
    )


def face_matrices(th, sc, c, s: int) -> np.ndarray:
    """Forward similarities [..., 2, 3] (source px -> crop px) of faces
    rotated by th, scaled by sc, whose centre c lands on the crop's centre."""
    ca, sa = sc * np.cos(th), sc * np.sin(th)
    half = s / 2
    return np.stack([
        np.stack([ca, -sa, half - (ca * c[..., 0] - sa * c[..., 1])], -1),
        np.stack([sa, ca, half - (sa * c[..., 0] + ca * c[..., 1])], -1),
    ], -2).astype(np.float32)


def warp_faces(dev, b: int, h: int, w: int, m=16, s=112) -> torch.Tensor:
    """Kernel 2's inverse matrices [B, 16, 2, 3]: faces of mixed size (45 to
    560 px) and rotation (up to 40 degrees), four of them centred on the
    border."""
    rng = np.random.default_rng(SEED + 1)
    th = rng.uniform(-0.7, 0.7, (b, m))
    sc = rng.uniform(0.2, 2.5, (b, m))
    c = rng.uniform(0, [w, h], (b, m, 2))
    c[:, 0, 0], c[:, 1, 0], c[:, 2, 1], c[:, 3, 1] = 0, w - 1, 0, h - 1
    return invert_similarity(torch.from_numpy(face_matrices(th, sc, c, s)).to(dev))


def check_warp_crops(dev, frames: torch.Tensor, m=16, s=112) -> dict:
    """Kernel 2 on the rendered uint8 frames [8, 640, 640, 3] with 16 faces a
    frame, and on two faces a frame far larger than the frame."""
    b, h, w, _ = frames.shape
    inv = warp_faces(dev, b, h, w, m, s)
    out = hold_warp(frames, inv, s)

    # faces of 1100 and 1900 px centred in the frame: a 16 x 16 tile of the
    # crop spans 160 source px and more, and most of each crop is the frame's
    # clamped border
    centre = np.broadcast_to(np.array([w / 2, h / 2]), (b, 2, 2))
    big = face_matrices(np.broadcast_to([0.5, -0.3], (b, 2)),
                        np.broadcast_to([0.1, 0.06], (b, 2)), centre, s)
    big = invert_similarity(torch.from_numpy(big).to(dev))
    big_err = max_err(align_cuda.warp_crops_kernel(frames, big, s),
                      align_cuda.warp_crops_plain(frames, big, s))
    if not big_err <= ATOL:
        raise AssertionError(f"warp_crops, faces larger than the frame: max abs err {big_err} > {ATOL}")
    return {**out, "large_face_max_abs_err": big_err}


def hold_warp(frames: torch.Tensor, inv: torch.Tensor, s=112) -> dict:
    """Kernel 2 on uint8 frames [B, H, W, 3] and inverse matrices [B, M, 2,
    3] against its plain version (floats within ATOL), then its median time
    over 50 launches, its bound, the plain version's time, and F.grid_sample
    over the same samples (the yardstick)."""
    b, h, w, _ = frames.shape
    m = inv.shape[1]
    dev = frames.device
    got = align_cuda.warp_crops_kernel(frames, inv, s)
    want = align_cuda.warp_crops_plain(frames, inv, s)
    torch.cuda.synchronize()
    err = max_err(got, want)
    if not err <= ATOL:
        raise AssertionError(f"warp_crops {tuple(frames.shape)}: max abs err {err} > {ATOL}")

    # the yardstick: one grid_sample over the f32 NCHW frames, every face's
    # 112 x 112 sample grid stacked along the output height
    src = frames.permute(0, 3, 1, 2).float().contiguous()
    g = torch.arange(s, dtype=torch.float32, device=dev) + 0.5
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    mi = inv[..., None, None]
    sx = mi[:, :, 0, 0] * gx + mi[:, :, 0, 1] * gy + mi[:, :, 0, 2]
    sy = mi[:, :, 1, 0] * gx + mi[:, :, 1, 1] * gy + mi[:, :, 1, 2]
    grid = torch.stack([sx * (2.0 / w) - 1.0, sy * (2.0 / h) - 1.0], -1).reshape(b, m * s, s, 2)

    def library():
        return F.grid_sample(src, grid, mode="bilinear", padding_mode="border",
                             align_corners=False)

    lib = library().reshape(b, 3, m, s, s).permute(0, 2, 3, 4, 1)
    # per output pixel: 8 for its sample coordinate, 4 for clamp and floor,
    # 2 for the weights, 6 a channel for the bilinear blend
    ops = b * m * s * s * (14 + 3 * 6)
    bms, by = bound(frames.numel() + inv.numel() * 4 + got.numel() * 4, ops)
    return dict(
        shape=f"B={b} {h}x{w} M={m} S={s}", max_abs_err=err,
        library_max_abs_err=max_err(lib, want),
        ms=device_ms(lambda: align_cuda.warp_crops_kernel(frames, inv, s)),
        plain_ms=device_ms(lambda: align_cuda.warp_crops_plain(frames, inv, s), 20, True),
        bound_ms=bms, bound_by=by, library_ms=device_ms(library),
    )


def greedy_input(dev, k: int, case: str = "smoke", b=FRAMES):
    """Kernel 3's inputs at B=8: the effective overlap [B, K, K] and the above
    mask [B, K]. "smoke": K boxes 16 to 160 px wide spread over a 640 frame,
    60 % of them above the score threshold; "sparse": the same boxes, 10 %
    above; "crowd": the decoded boxes of the detection head's crowd
    (``testing/payloads.py``), all above."""
    rng = np.random.default_rng(SEED + k)
    if case == "crowd":
        pay = torch.from_numpy(crowd_payload(rng, b, k, n_above=k)).to(dev)
        boxes = decode_boxes(pay[..., 0:4], pay[..., 14:18], 640.0)
        above = torch.ones((b, k), dtype=torch.bool, device=dev)
    else:
        ctr = rng.uniform(0, 640, (b, k, 2))
        wh = rng.uniform(16, 160, (b, k, 2))
        boxes = torch.from_numpy(
            np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)).to(dev)
        above = torch.from_numpy(rng.random((b, k)) < (0.6 if case == "smoke" else 0.1)).to(dev)
    return overlap_matrix(boxes, 0.4, 0.5), above


def check_greedy_nms(dev, k: int, case: str = "smoke") -> dict:
    """Kernel 3 at B=8 on one of ``greedy_input``'s inputs: the keep mask bit
    for bit, then the times."""
    return hold_greedy(*greedy_input(dev, k, case), case)


def hold_greedy(eff: torch.Tensor, above: torch.Tensor, case: str) -> dict:
    """Kernel 3 on an overlap [B, K, K] and its above mask: the keep mask
    against the plain version's bit for bit, then its median time over 50
    launches, its bound and the plain version's time."""
    b, k = above.shape
    got = nms_cuda.greedy_suppress_kernel(eff, above, 1.0)
    want = nms_cuda.greedy_suppress_plain(eff, above, 1.0)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"greedy_nms K={k} {case}: keep mask differs from the plain version")
    # the keep mask depends only on the overlaps of the pairs j > i: those
    # f32 values, the above flags and the keep flags, one compare a pair.
    # This is the function's nominal work: the kernel skips the rows and
    # words the greedy pass cannot read, so a share of this bound is no
    # efficiency
    pairs = b * k * (k - 1) / 2
    bms, by = bound(pairs * 4 + above.numel() + got.numel(), pairs)
    return dict(
        shape=f"B={b} K={k}, {100 * float(above.float().mean()):.0f} % above ({case}), "
              f"{int(got.sum()) // b} kept a frame",
        max_abs_err=max_err(got, want),
        ms=device_ms(lambda: nms_cuda.greedy_suppress_kernel(eff, above, 1.0)),
        plain_ms=device_ms(lambda: nms_cuda.greedy_suppress_plain(eff, above, 1.0), 3, True),
        bound_ms=bms, bound_by=by, library_ms=None,
    )


def nms_call_share(dev, k: int) -> dict:
    """What the greedy kernel is of a whole ``nms_padded_batched`` call on
    [8, 16800] decoded anchors (``random_head``) at pre_topk=k: the call's
    device time (top-k, gathers, ``overlap_matrix``, the kernel, the slot
    selection), the kernel's alone on the call's own overlap, and the call's
    time on the host's clock, which is the host's launches."""
    loc, ldm, scores, priors = random_head(dev)
    boxes = decode_boxes(loc, priors, 640.0)
    ldm = decode_landmarks(ldm, priors, 640.0)
    top_scores, top_idx = top_k(scores, k)
    eff = overlap_matrix(torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4)), 0.4, 0.5)
    above = top_scores >= 0.5

    def call():
        return nms_padded_batched(boxes, scores, ldm, pre_topk=k, max_out=16)

    # some twenty small ops a call: ten calls are what the host queues while
    # device_ms holds the stream
    out = dict(
        call_ms=device_ms(call, 10),
        kernel_ms=device_ms(lambda: nms_cuda.greedy_suppress_kernel(eff, above, 1.0)),
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    out["wall_ms"] = (time.perf_counter() - t0) * 1e3 / 20
    return out


# the chains' pass (csrc/bn_act.cu) at r50.stream's embed rung, in each of
# its seven modes at a shape where iresnet50's forward runs it, and at the
# cells' frames a batch where the detector runs it at det 640:
# name -> (B, C, H = W of the input, keywords of ``bn_act_call``)
BN_ACT_BATCH = 1664
DET_BATCH = 128
BN_ACT_CASES = {
    "stem": (BN_ACT_BATCH, 64, 112, dict(nxt=True)),                 # bn_prelu + block 0's bn1
    "stage1_pad": (BN_ACT_BATCH, 64, 112, dict(pad=(1, 1))),         # block 0's pass A, padded
    "stage1_A": (BN_ACT_BATCH, 64, 56, {}),                          # bn2, PReLU
    "stage1_down": (BN_ACT_BATCH, 64, 56, dict(sc=True, down=True)),  # bn3 + down_bn(sc), bn1
    "stage1_B": (BN_ACT_BATCH, 64, 56, dict(sc=True)),               # bn3 + block input, bn1
    "stage3_A": (BN_ACT_BATCH, 256, 14, {}),
    "stage3_B": (BN_ACT_BATCH, 256, 14, dict(sc=True)),
    "stage4_last": (BN_ACT_BATCH, 512, 7, dict(sc=True, keep=False)),  # head_bn of the sum
    "stage4_down_last": (BN_ACT_BATCH, 512, 7, dict(sc=True, down=True, keep=False)),
    "det_stem": (DET_BATCH, 8, 320, dict(leaky=True)),               # BN, leaky ReLU
    "det_stage1_pad": (DET_BATCH, 16, 320, dict(leaky=True, pad=(1, 1))),  # a stride-2 dw's input
    "det_stage2": (DET_BATCH, 128, 40, dict(leaky=True)),
    "det_stage3": (DET_BATCH, 256, 20, dict(leaky=True)),
    "det_ssh": (DET_BATCH, 16, 80, dict(leaky=True)),
    "det_prelu_pad": (DET_BATCH, 16, 320, dict(pad=(1, 1))),         # a real det export's PReLU
}


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """The most bf16 units in the last place between two bf16 tensors."""
    def ordered(t):
        b = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(b < 0, -(b & 0x7FFF), b)

    return int((ordered(got) - ordered(want)).abs().max())


def bn_act_call(route: str, x: torch.Tensor, sc: torch.Tensor | None, layers: dict,
                nxt: bool = False, pad=None, down: bool = False, keep: bool = True,
                leaky: bool = False) -> tuple:
    """One case of the pass as (y or r, u), None where not written: route
    "kernel" launches it, "eager" runs the eager bf16 chain the forward ran
    before (the plain twins), "f32" the chain computed in f32 from the same
    folds and rounded once to x's dtype (the plain version it is held to).
    ``leaky``: the detector's leaky ReLU at 0.1 in place of the PReLU."""
    bn_next = layers["bn_next"] if nxt or sc is not None else None
    down_bn = layers["down_bn"] if down else None
    if route != "f32":
        if leaky:
            f = bn_act_cuda.bn_leaky if route == "kernel" else bn_act_cuda.bn_leaky_plain
            return f(x, layers["bn"], 0.1, pad), None
        if sc is None:
            f = bn_act_cuda.bn_prelu if route == "kernel" else bn_act_cuda.bn_prelu_plain
            y = f(x, layers["bn"], layers["act"], bn_next=bn_next, pad=pad)
            return y if nxt else (y, None)
        f = bn_act_cuda.bn_add if route == "kernel" else bn_act_cuda.bn_add_plain
        return f(x, layers["bn"], sc, bn_next, down_bn=down_bn, keep=keep)

    def fold(bn):
        return [v.float() for v in nn.bn_fold(bn, x)]

    s, t = fold(layers["bn"])
    v = x.float() * s + t
    if sc is None:
        a = 0.1 if leaky else nn._cast(layers["act"], "alpha", x.dtype).float()[:, None, None]
        v = torch.where(v >= 0, v, a * v)
        if pad is not None:
            v = F.pad(v, (0, pad[1], 0, pad[0]))
    else:
        d = sc.float()
        if down_bn is not None:
            sd, td = fold(down_bn)
            d = d * sd + td
        v = d + v
    u = None
    if bn_next is not None:
        s1, t1 = fold(bn_next)
        u = (v * s1 + t1).to(x.dtype)
    return (v.to(x.dtype) if keep else None), u


def check_bn_act(dev) -> dict:
    """The chains' pass at r50.stream's rung and the detector's batch, bf16,
    in every case of ``BN_ACT_CASES``: each output held within 1 bf16 ulp of
    the f32 chain rounded once (the padded output's zero border included), timed beside
    that chain (the plain version), beside its bound (each input read once,
    each output written once, over 3.35 TB/s) and beside the eager bf16
    chain the forward ran before (``library_ms``, a yardstick the port no
    longer runs)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)

    def param(lo, hi, c, normal=False):
        v = rng.normal(lo, hi, c) if normal else rng.uniform(lo, hi, c)
        return torch.from_numpy(v.astype(np.float32)).to(dev)

    out = {}
    for name, (b, c, h, kw) in BN_ACT_CASES.items():
        layers = {k: {"gamma": param(0.5, 1.5, c), "beta": param(0, 0.3, c, True),
                      "mean": param(0, 0.3, c, True), "var": param(0.5, 2.0, c)}
                  for k in ("bn", "bn_next", "down_bn")}
        layers["act"] = {"alpha": param(0.05, 0.45, c)}
        x, sc = (torch.randn((b, h, h, c), generator=gen, device=dev)
                 .to(torch.bfloat16).permute(0, 3, 1, 2) for _ in range(2))
        kw = dict(kw)
        sc = sc if kw.pop("sc", False) else None

        def run(route):
            return bn_act_call(route, x, sc, layers, **kw)

        got, want, eager = run("kernel"), run("f32"), run("eager")
        torch.cuda.synchronize()
        pairs = [(g, w, e) for g, w, e in zip(got, want, eager) if w is not None]
        if any(g is None or g.shape != w.shape for g, w, _ in pairs) or len(pairs) != sum(
                g is not None for g in got):
            raise AssertionError(f"bn_act {name}: outputs {[None if g is None else tuple(g.shape) for g in got]}")
        ulps = max(bf16_ulps(g, w) for g, w, _ in pairs)
        if ulps > 1:
            raise AssertionError(f"bn_act {name}: {ulps} bf16 ulps from the f32 chain rounded once")
        err = max(max_err(g, w) for g, w, _ in pairs)
        lib_err = max(max_err(g, e) for g, _, e in pairs)
        n_in = x.numel() * (1 if sc is None else 2)
        n_out = sum(g.numel() for g, _, _ in pairs)
        del got, want, eager, pairs
        bound_ms, bound_by = bound(2 * (n_in + n_out) + 7 * c * 2, 0)
        out[name] = dict(
            shape=[b, c, h, h], max_ulps=ulps, max_abs_err=err,
            ms=device_ms(lambda: run("kernel")), bound_ms=bound_ms, bound_by=bound_by,
            plain_ms=device_ms(lambda: run("f32"), reps=10, host_bound=True),
            library_ms=device_ms(lambda: run("eager"), reps=20, host_bound=True),
            library_max_abs_err=lib_err)
        del x, sc
        torch.cuda.empty_cache()
    return out


# the add-LN pass (csrc/add_ln.cu) at the embed rung of 1664 faces: name ->
# (rows, width, whether the site is the last: the final LN in float32, r not
# written); the ViT-L's 144 tokens of 768 (vitl.stream), the Swin-T's four
# residual streams (swint.stream: 3136 tokens of 96, 784 of 192, 196 of 384,
# 49 of 768)
ADD_LN_RUNG = 1664
ADD_LN_CASES = {
    "block": (ADD_LN_RUNG * 144, 768, False),
    "last": (ADD_LN_RUNG * 144, 768, True),
    "swin_s1": (ADD_LN_RUNG * 3136, 96, False),
    "swin_s2": (ADD_LN_RUNG * 784, 192, False),
    "swin_s3": (ADD_LN_RUNG * 196, 384, False),
    "swin_s4": (ADD_LN_RUNG * 49, 768, False),
    "swin_last": (ADD_LN_RUNG * 49, 768, True),
}


def add_ln_call(route: str, x: torch.Tensor, d: torch.Tensor, ln: dict, last: bool) -> tuple:
    """One site of the pass as (r, LN(r)), r None at the last: route
    "kernel" launches it, "eager" runs the eager bf16 ops the forward ran
    before (the plain twin), "f32" the kernel's arithmetic in f32 rounded
    once (``add_ln_f32``, the plain version it is held to)."""
    f = {"kernel": add_ln_cuda.add_ln, "eager": add_ln_cuda.add_ln_plain,
         "f32": add_ln_cuda.add_ln_f32}[route]
    return f(x, d, ln, 1e-5, last=last)


def check_add_ln(dev) -> dict:
    """The add-LN pass at the embed rung, bf16, at each shape and site kind
    of ``ADD_LN_CASES``: r held equal to the f32 sum rounded once and LN(r)
    equal to the kernel's arithmetic in f32 rounded once (``add_ln_f32``,
    the plain version, 0 ulps), timed beside it, beside its bound
    (x and d read once, r and LN(r) written once, over 3.35 TB/s) and
    beside the eager add and LN the forward ran before (``library_ms``, a
    yardstick the port no longer runs), with its largest difference from
    them."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    out = {}
    for name, (rows, w, last) in ADD_LN_CASES.items():
        ln = {"gamma": torch.from_numpy(rng.uniform(0.8, 1.2, w).astype(np.float32)).to(dev),
              "beta": torch.from_numpy(rng.normal(0, 0.2, w).astype(np.float32)).to(dev)}
        x, d = (torch.randn((rows, w), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))

        def run(route):
            return add_ln_call(route, x, d, ln, last)

        got, want, eager = run("kernel"), run("f32"), run("eager")
        torch.cuda.synchronize()
        if (got[0] is None) != last or (not last and not torch.equal(got[0], want[0])):
            raise AssertionError(f"add_ln {name}: r is not x + d rounded once")
        ulps = bf16_ulps(got[1], want[1])
        if ulps:
            raise AssertionError(f"add_ln {name}: {ulps} bf16 ulps from its f32 arithmetic "
                                 "rounded once")
        err, lib_err = max_err(got[1], want[1]), max_err(got[1], eager[1])
        del got, want, eager
        n = x.numel()
        bound_ms, bound_by = bound(2 * (2 * n + (1 if last else 2) * n)
                                   + 2 * w * (4 if last else 2), 0)
        out[name] = dict(
            shape=[rows, w], max_ulps=ulps, max_abs_err=err,
            ms=device_ms(lambda: run("kernel")), bound_ms=bound_ms, bound_by=bound_by,
            plain_ms=device_ms(lambda: run("f32"), reps=10, host_bound=True),
            library_ms=device_ms(lambda: run("eager"), reps=20, host_bound=True),
            library_max_abs_err=lib_err)
        del x, d
        torch.cuda.empty_cache()
    return out


# --- phases 4 to 7: the engine -----------------------------------------------

STAGES = ("ingest", "delta_ingest", "detect", "crop", "embed", "match_pack", "match")
# the CUDA runtime's calls that block the host until the card has caught up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpy")


def span_device_us(ev) -> float:
    """The device us of the kernels and copies launched inside a host event
    and its children, each id's once (another host event may carry the id
    of the op that launched a kernel, and a second copy of its kernels)."""
    by_id: dict = {}
    todo = [ev]
    while todo:
        e = todo.pop()
        if e.kernels and e.id not in by_id:
            by_id[e.id] = sum(k.duration for k in e.kernels)
        todo.extend(e.cpu_children)
    return sum(by_id.values())


def made_in(ev, name: str) -> bool:
    """Whether a host event is nested in a span ``name`` and was made on
    that span's system thread (another thread's runtime call can land in
    the tree by time)."""
    p = ev.cpu_parent
    while p is not None:
        if p.name == name:
            return getattr(ev, "device_resource_id", None) == getattr(p, "device_resource_id", None)
        p = p.cpu_parent
    return False


def program_spans(fn) -> tuple:
    """fn() under torch.profiler over every thread: (its result, {span
    name: [device ms of each of the engine's ``frp.*`` spans of that name,
    in start order]}, {call: the synchronizing CUDA calls nested in the
    spans ``frp.submit_encoded`` and ``frp.fetch_many``})."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **all_threads()) as prof:
        out = fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in prof.events() if e.device_type != cuda]
    spans: dict[str, list[float]] = {}
    for e in sorted(host, key=lambda e: e.time_range.start):
        if e.name.startswith("frp."):
            spans.setdefault(e.name, []).append(span_device_us(e) / 1e3)
    syncs = {call: sum(1 for e in host if e.name in SYNC_CALLS and made_in(e, f"frp.{call}"))
             for call in ("submit_encoded", "fetch_many")}
    return out, spans, syncs


def stage_ms(spans: dict) -> dict[str, float]:
    """Median device ms of each stage span (``program_spans``)."""
    return {k: float(np.median(spans[f"frp.{k}"])) for k in STAGES if f"frp.{k}" in spans}


def run_scan(dev, scenes: np.ndarray, profile: dict, ticks: int, warm: int) -> dict:
    """Phase 4: the delta scan, the resident-batch check and the enrolment."""
    eng = RecognitionEngine(load_config(**profile), device=dev)
    enc = DeltaEncoder(block_bytes=128)
    batches = [tick_batch(scenes, t) for t in range(ticks + 2 + SYNC_BATCHES)]
    payloads = [enc.encode(x) for x in batches]
    kinds = [p[0] for p in payloads]
    if kinds != ["raw"] + ["delta"] * (ticks + 1 + SYNC_BATCHES):
        raise AssertionError(f"payload kinds {kinds}")
    timed = dev.type == "cuda"
    reset_launches()
    n_batches, faces, t0 = 0, 0, None
    host, submit_ms = None, []
    for t in range(ticks + 1):
        if t == warm:
            if timed:
                torch.cuda.synchronize()
            t0, faces = time.perf_counter(), 0
        t_submit = time.perf_counter()
        handle = eng.submit_encoded(payloads[t])
        if t >= warm:
            submit_ms.append((time.perf_counter() - t_submit) * 1e3)
        out = eng.fetch(handle)
        n_batches += 1
        faces += int(out["count"].sum())
        flat = batches[t].reshape(len(scenes), -1)
        host = flat.copy() if t == 0 else DeltaEncoder.apply_host(host, payloads[t][1], payloads[t][2])
    elapsed = time.perf_counter() - t0
    steady = ticks + 1 - warm
    if not np.array_equal(host, batches[ticks].reshape(len(scenes), -1)):
        raise AssertionError("apply_host did not rebuild the last batch")
    resident = eng._delta_prev.cpu().numpy().reshape(host.shape)
    if not np.array_equal(resident, host):
        raise AssertionError("the resident batch differs from DeltaEncoder.apply_host")
    if not out["valid"].any():
        raise AssertionError("the scan found no face")
    sync_payloads = payloads[ticks + 1 : ticks + 1 + SYNC_BATCHES]
    # the sync counts and stage spans read the card's; the CPU runs the batches only
    syncs, span_syncs, stages = None, None, {}
    if timed:
        syncs, spans, span_syncs = program_spans(lambda: steady_syncs(eng, sync_payloads))
        stages = stage_ms(spans)
    else:
        for p in sync_payloads:
            eng.fetch(eng.submit_encoded(p))
    n_batches += SYNC_BATCHES

    # enrol one face of a frame that has one, then scan once more
    j = int(np.flatnonzero(out["valid"].any(axis=1))[0])
    enrolled = eng.encode_image(scenes[j])
    if not enrolled:
        raise AssertionError(f"encode_image found no face in scene {j}")
    eng.gallery.add("enrolled", enrolled[0]["embedding"])
    after = eng.fetch(eng.submit_encoded(payloads[ticks + 1 + SYNC_BATCHES]))
    n_batches += 2
    slot = after["gallery_names"].index("enrolled")
    hit = after["valid"][j] & after["is_match"][j] & (after["best_idx"][j] == slot)
    if not hit.any():
        raise AssertionError(f"the enrolled face did not match in frame {j}: "
                             f"distances {after['best_distance'][j][after['valid'][j]]}")
    got = launches()
    want = {"detection_head": n_batches, "warp_crops": n_batches, "greedy_nms": 0}
    if timed and got != want:
        raise AssertionError(f"launches {got}, expected {want}")
    return dict(
        engine=eng, out=out, launches=got, batches=n_batches,
        chains=chain_launches(dev),
        frames_per_s=steady * len(scenes) / elapsed, faces_per_s=faces / elapsed,
        faces_per_batch=faces / steady, ms_per_batch=elapsed * 1e3 / steady,
        stage_ms=stages, enrolled_frame=j,
        enrolled_distance=float(after["best_distance"][j][hit].min()),
        submit_ms=float(np.median(submit_ms)), syncs=syncs, span_syncs=span_syncs,
        embed=dict(eng.embed_stats),
    )


def steady_syncs(eng: RecognitionEngine, payloads: list) -> dict:
    """The host syncs (``host_syncs``) of steady batches of a scan, one
    payload each: each batch's submit_encoded, and its fetch."""
    out: dict = {"submit": [], "fetch": []}
    for payload in payloads:
        handle = {}
        out["submit"].append(host_syncs(lambda: handle.update(h=eng.submit_encoded(payload))))
        out["fetch"].append(host_syncs(lambda: eng.fetch(handle["h"])))
    return out


def run_nms_engine(dev, scenes: np.ndarray, profile: dict) -> dict:
    """Phase 5: pre_nms_topk=512 routes detect through the greedy kernel."""
    eng = RecognitionEngine(load_config(**{**profile, "pre_nms_topk": 512}), device=dev)
    payload = DeltaEncoder(block_bytes=128).encode(tick_batch(scenes, 0))
    reset_launches()
    out = eng.fetch(eng.submit_encoded(payload))
    got = launches()
    if dev.type == "cuda" and got != {"detection_head": 0, "warp_crops": 1, "greedy_nms": 1}:
        raise AssertionError(f"pre_nms_topk=512 launches {got}")
    if not out["valid"].any():
        raise AssertionError("the pre_nms_topk=512 engine found no face")
    return dict(launches=got, faces=int(out["count"].sum()))


def run_parity(dev, scenes: np.ndarray, profile: dict) -> dict:
    """Phase 6: the same engine at f32 on dev and on the CPU, 2 frames."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = {**profile, "compute_dtype": "float32"}
    engs = [RecognitionEngine(load_config(**f32), device=d) for d in (dev, "cpu")]
    batch = tick_batch(scenes, 0)
    ref = engs[1].process_frames(batch, fmt="yuv420")
    if not ref["valid"].any():
        raise AssertionError("the CPU engine found no face in the parity frames")
    # enrol each face at its own norm (an empty slot's zero query is nearest
    # to the shortest entry; equal norms would make that a rounding tie)
    embs = ref["embeddings"][ref["valid"]]
    embs = embs * np.linspace(1.0, 0.8, len(embs), dtype=np.float32)[:, None]
    decoys = np.random.default_rng(SEED).normal(size=(3, embs.shape[1])).astype(np.float32)
    for eng in engs:
        for n, e in enumerate([*embs, *decoys]):
            eng.gallery.add(f"id{n}", e)
    res = [eng.fetch(eng.submit_encoded(DeltaEncoder(block_bytes=128).encode(batch))) for eng in engs]
    got, want = res
    for key in ("valid", "count", "best_idx"):
        if not np.array_equal(got[key], want[key]):
            raise AssertionError(f"cuda and cpu engines differ in {key}")
    v = want["valid"]
    errs = {key: float(np.abs(got[key][v] - want[key][v]).max())
            for key in ("boxes", "landmarks", "scores", "best_distance", "fake_prob", "quality")}
    if not errs["boxes"] <= 1e-2:
        raise AssertionError(f"cuda and cpu boxes differ by {errs['boxes']} px")
    return dict(faces=int(v.sum()), max_abs_err=errs)


def run_fused(dev, scenes: np.ndarray, profile: dict, eng: RecognitionEngine,
              enrolled_frame: int, calls: int = 20) -> dict:
    """Phase 7: build_pipeline over the scenes as uint8 RGB against the staged
    engine `eng` (its weights, priors, distance scale and gallery, in which
    phase 4 enrolled a face of scene `enrolled_frame`)."""
    cfg = load_config(**profile)
    pipeline = build_pipeline(
        device=dev, det_size=cfg.det_size, max_faces=cfg.max_faces_per_frame,
        pre_nms_topk=cfg.pre_nms_topk, conf_thresh=cfg.det_conf_threshold,
        nms_thresh=cfg.det_nms_threshold, iom_thresh=cfg.det_nms_iom_threshold,
        tolerance=cfg.face_tolerance, compute_dtype=cfg.compute_dtype,
        distance_scale=eng.distance_scale)
    want = eng.process_frames(scenes)
    gallery, gallery_valid, names = eng.gallery.device_view()
    frames = torch.from_numpy(scenes).to(dev)
    timed = dev.type == "cuda"

    def call():
        return pipeline(eng.params, frames, gallery, gallery_valid, eng._priors)

    reset_launches()
    got = {k: v.cpu().numpy() for k, v in call().items()}
    first = launches()
    if timed and first != {"detection_head": 0, "warp_crops": 1, "greedy_nms": 1}:
        raise AssertionError(f"build_pipeline launches {first} a call")
    for key in ("valid", "count", "best_idx"):
        if not np.array_equal(got[key], want[key]):
            raise AssertionError(f"build_pipeline and the staged engine differ in {key}: "
                                 f"{got[key].tolist()} against {want[key].tolist()}")
    v = want["valid"]
    if not v.any():
        raise AssertionError("build_pipeline found no face")
    errs = {key: float(np.abs(got[key][v] - want[key][v]).max())
            for key in ("boxes", "embeddings", "fake_prob", "quality", "best_distance")}
    for key, tol in (("boxes", 1e-2), ("embeddings", 2e-2), ("fake_prob", 2e-2)):
        if not errs[key] <= tol:
            raise AssertionError(f"build_pipeline and the staged engine differ in {key} by {errs[key]}")
    j, slot = enrolled_frame, names.index("enrolled")
    hit = got["valid"][j] & got["is_match"][j] & (got["best_idx"][j] == slot)
    if not hit.any():
        raise AssertionError(f"the enrolled face did not match in frame {j} of build_pipeline")
    if timed:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    if timed:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    return dict(launches=launches(), calls=calls + 1, faces=int(v.sum()), max_abs_err=errs,
                ms_per_call=ms, enrolled_distance=float(got["best_distance"][j][hit].min()))


def param_count(tree) -> int:
    """Numbers in a converted parameter tree (the per-dtype caches left out)."""
    if isinstance(tree, dict):
        return sum(param_count(v) for k, v in tree.items() if not str(k).startswith("_"))
    if isinstance(tree, list):
        return sum(param_count(v) for v in tree)
    return tree.numel() if isinstance(tree, torch.Tensor) else 0


def embed_bound(eng: RecognitionEngine, frames_yuv: np.ndarray, compact: bool) -> dict:
    """The embed stage's work on one batch: its matmul and conv FLOPs as
    FlopCounterMode counts them (the rung it picks, both flip-TTA forwards,
    spoof), the bytes it must move (the crops it runs on, read once, and the
    weights at the compute dtype, read once), and the least time they take.
    `compact` says whether the engine was built with compaction on."""
    with torch.no_grad():
        rgb = eng._stages["ingest"](eng._upload(frames_yuv))
        dets = eng._stages["detect"](eng.params["detector"], rgb, eng._priors)
        crops = eng._stages["crop"](rgb, dets)["crops"]
        flops = counted_flops(eng._stages["embed"], eng.params, crops, dets["valid"],
                              eng.distance_scale)
    nv = int(dets["valid"].sum())
    n = dets["valid"].numel()
    rung = next((k for k in embed_compact_rungs(n) if nv <= k), n) if compact else n
    width = torch.finfo(getattr(torch, eng.cfg.compute_dtype)).bits // 8
    nbytes = rung * 112 * 112 * 3 * 4 + width * (
        param_count(eng.params["embedder"]) + param_count(eng.params["spoof"]))
    tb, to = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS_BF16
    return dict(flops=flops, bytes=nbytes, faces=nv, slots=n, rung=rung,
                bound_ms=max(tb, to) * 1e3, bound_by="bytes" if tb >= to else "operations")


def stream_ms(eng: RecognitionEngine, payloads: list, warm: int) -> dict:
    """ms/batch on the host clock over payloads[warm:], each submitted then
    fetched; then the same payloads again, payloads[warm:] under
    torch.profiler, for the median device ms of each stage (``stage_ms``).
    Runs 2 * len(payloads) batches."""
    faces = 0
    for t, p in enumerate(payloads):
        if t == warm:
            torch.cuda.synchronize()
            t0, faces = time.perf_counter(), 0
        faces += int(eng.fetch(eng.submit_encoded(p))["count"].sum())
    elapsed = time.perf_counter() - t0
    for p in payloads[:warm]:
        eng.fetch(eng.submit_encoded(p))
    _, spans, _ = program_spans(lambda: [eng.fetch(eng.submit_encoded(p)) for p in payloads[warm:]])
    return dict(stage_ms=stage_ms(spans), ms_per_batch=elapsed * 1e3 / (len(payloads) - warm),
                faces_per_batch=faces / (len(payloads) - warm))


def device_busy_ms(eng: RecognitionEngine, payloads: list, warm: int) -> float | None:
    """Device-busy ms a batch over payloads[warm:], each submitted then
    fetched, from a torch.profiler trace (busy_ms): the union of the card's
    kernel and copy intervals, over the batches. None when the trace holds
    no device activity."""
    for p in payloads[:warm]:
        eng.fetch(eng.submit_encoded(p))
    rest = iter(payloads[warm:])
    return busy_ms(lambda: eng.fetch(eng.submit_encoded(next(rest))), len(payloads) - warm)[0]


def compaction_runs(dev, scenes: np.ndarray, profile: dict, eng: RecognitionEngine,
                    ticks: int, warm: int, rounds: int) -> dict:
    """`eng` (compaction on) against the same profile built with
    FRP_EMBED_COMPACT=0 and given the same gallery: one batch held (valid,
    count, best_idx bit for bit, embeddings and fake_prob within 2e-2), the
    embed stage's work and bound on it, then `rounds` turns of a short delta
    stream on each (embed device ms, ms/batch) and one profiled stream on
    each (device-busy ms a batch). Returns the numbers and the batches run."""
    os.environ["FRP_EMBED_COMPACT"] = "0"
    try:
        off = RecognitionEngine(load_config(**profile), device=dev)
    finally:
        del os.environ["FRP_EMBED_COMPACT"]
    for name in eng.gallery.names:
        off.gallery.add(name, eng.gallery.get(name))
    batch = tick_batch(scenes, ticks)
    got, want = eng.process_frames(batch, fmt="yuv420"), off.process_frames(batch, fmt="yuv420")
    for key in ("valid", "count", "best_idx"):
        if not np.array_equal(got[key], want[key]):
            raise AssertionError(f"compaction on and off differ in {key}")
    v = want["valid"]
    errs = {key: float(np.abs(got[key][v] - want[key][v]).max()) for key in ("embeddings", "fake_prob")}
    for key, err in errs.items():
        if not err <= 2e-2:
            raise AssertionError(f"compaction on and off differ in {key} by {err}")
    bounds = {"on": embed_bound(eng, batch, True), "off": embed_bound(off, batch, False)}

    enc = DeltaEncoder(block_bytes=128)
    payloads = [enc.encode(tick_batch(scenes, t)) for t in range(min(ticks, 10) + 1)]
    per: dict[str, list] = {"on": [], "off": []}
    for _ in range(rounds):
        for key, e in (("on", eng), ("off", off)):
            per[key].append(stream_ms(e, payloads, warm))
    busy = {key: device_busy_ms(e, payloads, warm) for key, e in (("on", eng), ("off", off))}
    return dict(max_abs_err=errs, faces=int(v.sum()), bound=bounds, busy_ms=busy,
                batches=(4 * rounds + 2) * len(payloads) + 4,  # + process_frames, bound runs
                embed_ms={key: [r["stage_ms"]["embed"] for r in runs] for key, runs in per.items()},
                stream_ms_per_batch={key: [r["ms_per_batch"] for r in runs] for key, runs in per.items()})


def run_accuracy(dev, scenes: np.ndarray, ticks: int, warm: int, default_eng: RecognitionEngine,
                 rounds: int = 2) -> dict:
    """Phase 8: the accuracy profile's scan (phase 4's checks), then its
    compaction on against off, and for comparison the default profile's
    (`default_eng`, phase 4's engine). Returns phase 4's numbers plus the
    compaction runs' under "compaction" and "default_compaction"."""
    scan = run_scan(dev, scenes, ACCURACY, ticks, warm)
    eng = scan["engine"]
    if abs(eng.distance_scale - ACCURACY_SCALE) > 1e-9:
        raise AssertionError(f"accuracy distance_scale {eng.distance_scale}, expected {ACCURACY_SCALE}")
    if not str(eng.weights_loaded["embedder"]).endswith("iresnet18.npz"):
        raise AssertionError(f"accuracy embedder loaded from {eng.weights_loaded['embedder']}")
    comp = compaction_runs(dev, scenes, ACCURACY, eng, ticks, warm, rounds)
    base = compaction_runs(dev, scenes, PROFILE, default_eng, ticks, warm, rounds)
    n_batches = comp["batches"] + base["batches"]
    got = launches()
    want = {name: n + (n_batches if name != "greedy_nms" else 0)
            for name, n in scan["launches"].items()}
    if dev.type == "cuda" and got != want:
        raise AssertionError(f"compaction runs: launches {got}, expected {want}")
    scan.update(launches=got, batches=scan["batches"] + n_batches,
                chains=chain_launches(dev),
                compaction=comp, default_compaction=base)
    return scan


def serial_pass(eng: RecognitionEngine, payloads: list, group: int, sync) -> tuple[list, float]:
    """Each payload submitted then fetched; (results, seconds after the
    first `group` payloads)."""
    out = []
    for t, p in enumerate(payloads):
        if t == group:
            sync()
            t0 = time.perf_counter()
        out.append(eng.fetch(eng.submit_encoded(p)))
    sync()
    return out, time.perf_counter() - t0


def piped_pass(eng: RecognitionEngine, payloads: list, group: int, sync) -> tuple[list, float]:
    """put_payload on a second thread feeding a queue, submit_encoded on this
    one, fetch_many in groups of `group`; (results, seconds after the first
    group)."""
    q: queue.Queue = queue.Queue(maxsize=2 * group)
    failed: list = []

    def transfer():
        try:
            for p in payloads:
                q.put(eng.put_payload(p))
        except BaseException as e:  # handed to the main thread, which raises it
            failed.append(e)
            q.put(None)

    th = threading.Thread(target=transfer, name="put_payload", daemon=True)
    th.start()
    out, handles = [], []
    for t in range(len(payloads)):
        if t == group:
            sync()
            t0 = time.perf_counter()
        p = q.get(timeout=300)
        if p is None:
            raise failed[0]
        handles.append(eng.submit_encoded(p))
        if len(handles) == group or t == len(payloads) - 1:
            out.extend(eng.fetch_many(handles))
            handles = []
    sync()
    seconds = time.perf_counter() - t0
    th.join(timeout=60)
    if th.is_alive():
        raise AssertionError("the put_payload thread did not finish")
    return out, seconds


def run_pipelined(dev, scenes: np.ndarray, profile: dict, ticks: int, group: int = 4) -> dict:
    """Phase 9: one stream four times on one engine, in turns submitted then
    fetched batch by batch, and pipelined (put_payload on a second thread,
    fetch_many in groups of `group`), with the delta rungs precompiled after
    the first pass; each pass timed over the payloads after the first group.
    Every pipelined pass must equal the first serial one."""
    eng = RecognitionEngine(load_config(**profile), device=dev)
    enc = DeltaEncoder(block_bytes=128)
    payloads = [enc.encode(tick_batch(scenes, t)) for t in range(ticks + 1)]
    timed = dev.type == "cuda"

    def sync():
        if timed:
            torch.cuda.synchronize()

    reset_launches()
    want, first = serial_pass(eng, payloads, group, sync)
    seconds = {"serial": [first], "piped": []}
    before = eng._delta_prev.clone()
    rungs = eng.precompile_delta_rungs()
    if rungs != len(DeltaEncoder.LADDER):
        raise AssertionError(f"precompile_delta_rungs ran {rungs} rungs, expected {len(DeltaEncoder.LADDER)}")
    if not torch.equal(eng._delta_prev, before):
        raise AssertionError("precompile_delta_rungs changed the resident batch")
    errs: dict[str, float] = {}
    for kind in ("piped", "piped", "serial"):
        got, sec = (piped_pass if kind == "piped" else serial_pass)(eng, payloads, group, sync)
        seconds[kind].append(sec)
        for g, w in zip(got, want):
            for key in ("valid", "count", "best_idx", "is_match"):
                if not np.array_equal(g[key], w[key]):
                    raise AssertionError(f"{kind} pass and the first pass differ in {key}")
            v = w["valid"]
            for key in ("boxes", "landmarks", "scores", "best_distance", "fake_prob", "quality", "blur_score"):
                err = float(np.abs(g[key][v] - w[key][v]).max()) if v.any() else 0.0
                errs[key] = max(errs.get(key, 0.0), err)
    for key, err in errs.items():
        if not err <= ATOL:
            raise AssertionError(f"a later pass and the first pass differ in {key} by {err}")
    counts = launches()
    if eng.delta_stats["desyncs"] != 0:
        raise AssertionError(f"delta_stats {eng.delta_stats}")
    n_batches = 4 * len(payloads) + rungs
    if timed and counts != {"detection_head": n_batches, "warp_crops": n_batches, "greedy_nms": 0}:
        raise AssertionError(f"pipelined phase launches {counts}, expected {n_batches} batches")
    steady = len(payloads) - group
    return dict(launches=counts, batches=n_batches, rungs=rungs, max_abs_err=errs, steady=steady,
                ms_per_batch={k: [x * 1e3 / steady for x in v] for k, v in seconds.items()},
                frames_per_s={k: [steady * len(scenes) / x for x in v] for k, v in seconds.items()})


# --- phase 10: the serving platform -------------------------------------------

PLATFORM_CAMERAS = 8
PLATFORM_SOURCE = (1920, 1080)  # the bench protocol's 8 x 1080p feeds
PLATFORM_REQUESTS = 20
PROFILED_SCANS = 5  # phase 10's dry scans under torch.profiler
ENROLLED = "camera0_person"


def platform_app(dev, data_dir: str, source: str | None = None, **overrides):
    """The port's app as its entry point builds it, from the default config
    (or `overrides` of it) with a data dir of its own and 8 cameras of
    `source` (synthetic PLATFORM_SOURCE frames when None). The engine keeps
    the bytes of every payload it is sent and every result it returns: the
    dict of lists ("payload_bytes", "out") that comes back with (router,
    sio, ctx)."""
    source = source or "synthetic:%dx%d" % PLATFORM_SOURCE
    cfg = load_config(data_dir=data_dir, log_dir=os.path.join(data_dir, "logs"), **overrides)
    cams = [{"id": i, "name": f"Camera {i}", "geo": (18.52 + 0.01 * i, 73.85),
             "source": source} for i in range(PLATFORM_CAMERAS)]
    router, sio, ctx = build_app(AppContext(cfg=cfg, camera_configs=cams, device=dev))
    seen: dict = {"payload_bytes": [], "out": []}
    submit, fetch = ctx.engine.submit_encoded, ctx.engine.fetch

    def recording_submit(enc, *args, **kwargs):
        seen["payload_bytes"].append(sum(int(a.nbytes) for a in enc[1:]))
        return submit(enc, *args, **kwargs)

    def recording_fetch(handle):
        out = fetch(handle)
        seen["out"].append(out)
        return out

    ctx.engine.submit_encoded, ctx.engine.fetch = recording_submit, recording_fetch
    return router, sio, ctx, seen


def enrol(ctx, frame_bgr: np.ndarray, contexts=()) -> float:
    """Enrol the face of a BGR camera frame as ENROLLED through the face
    service (encode_image, then store_face into ctx and `contexts`); returns
    its detection score."""
    enc = ctx.face_service.encode_image(np.ascontiguousarray(frame_bgr[..., ::-1]))
    if not enc["success"] or not enc["faces"]:
        raise AssertionError(f"encode_image found no face in the enrolment frame: {enc}")
    face = max(enc["faces"], key=lambda f: f["score"])
    for c in (ctx, *contexts):
        c.face_service.store_face(ENROLLED, face["embedding"])
    return face["score"]


def start_server(router, sio):
    """The port's HTTPServer on 127.0.0.1:0 in an event loop thread of its
    own; returns (port, stop), stop() closes it and joins the thread."""
    server = HTTPServer(router, ws_handler=sio.handle_upgrade)
    loop = asyncio.new_event_loop()
    bound: dict = {}
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)

        async def boot():
            s = await server.start("127.0.0.1", 0)
            bound["port"] = s.sockets[0].getsockname()[1]
            started.set()

        loop.run_until_complete(boot())
        loop.run_forever()

    th = threading.Thread(target=run, name="http", daemon=True)
    th.start()
    if not started.wait(30):
        raise AssertionError("the HTTP server did not start")

    def stop():
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        th.join(30)
        if th.is_alive():
            raise AssertionError("the HTTP server thread did not stop")
        loop.close()

    return bound["port"], stop


async def http_call(port: int, method: str, path: str, body: bytes = b"",
                    headers: dict | None = None) -> tuple[int, dict, bytes]:
    """One HTTP/1.1 request to the server on 127.0.0.1:port; returns (status,
    headers with lower-case names, body)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    head = {"Host": "localhost", **(headers or {})}
    if body:
        head["Content-Length"] = str(len(body))
    writer.write((f"{method} {path} HTTP/1.1\r\n"
                  + "".join(f"{k}: {v}\r\n" for k, v in head.items())).encode() + b"\r\n" + body)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    got = {}
    while (line := await reader.readline()) not in (b"\r\n", b""):
        k, v = line.decode().split(":", 1)
        got[k.strip().lower()] = v.strip()
    data = await reader.readexactly(int(got.get("content-length", 0)))
    writer.close()
    return status, got, data


async def http_get(port: int, path: str) -> tuple[int, dict]:
    status, _, body = await http_call(port, "GET", path)
    return status, json.loads(body)


def ws_frame(data: bytes) -> bytes:
    """A masked client text frame (payloads under 126 bytes)."""
    mask = os.urandom(4)
    return bytes([0x81, 0x80 | len(data)]) + mask + bytes(b ^ mask[i % 4] for i, b in enumerate(data))


async def drive_platform(port: int, requests: int, path: str) -> dict:
    """A Socket.IO client that counts new_alert events, and `requests` GETs
    of `path` one after the other; then the alert list, the timers and the
    delta counters over the same socket API."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    key = base64.b64encode(os.urandom(16)).decode()
    writer.write((
        "GET /socket.io/?EIO=4&transport=websocket HTTP/1.1\r\nHost: localhost\r\n"
        "Upgrade: websocket\r\nConnection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n").encode())
    await writer.drain()
    if b"101" not in await reader.readline():
        raise AssertionError("the Socket.IO upgrade was refused")
    while (await reader.readline()) not in (b"\r\n", b""):
        pass
    await asyncio.wait_for(read_frame(reader), 10)  # engine.io open
    writer.write(ws_frame(b"40"))
    await writer.drain()
    if not (await asyncio.wait_for(read_frame(reader), 10))[1].startswith(b"40"):
        raise AssertionError("no Socket.IO connect acknowledgement")
    pushed: list = []

    async def listen():
        while (frame := await read_frame(reader)) is not None:
            text = frame[1].decode(errors="replace")
            if text == "2":  # engine.io ping
                writer.write(ws_frame(b"3"))
            elif text.startswith("42"):
                event, data = json.loads(text[2:])
                if event == "new_alert":
                    pushed.append(data)

    listener = asyncio.create_task(listen())
    scans = []
    t0 = time.perf_counter()
    for _ in range(requests):
        t = time.perf_counter()
        status, body = await http_get(port, path)
        scans.append(dict(status=status, body=body, wall_s=time.perf_counter() - t))
    seconds = time.perf_counter() - t0
    await asyncio.sleep(0.5)  # the last scan's pushes
    listener.cancel()
    writer.close()
    return dict(scans=scans, seconds=seconds, pushed=pushed,
                alerts=(await http_get(port, "/alerts?limit=200"))[1],
                timers=(await http_get(port, "/debug/timers"))[1],
                delta=(await http_get(port, "/debug/delta"))[1])


def run_platform(dev, requests: int = PLATFORM_REQUESTS, **overrides) -> dict:
    """Phase 10: the serving platform on the card at full width (the default
    config; `overrides` of it only for a rehearsal on the CPU)."""
    tmp = tempfile.mkdtemp(prefix="frp_platform_")
    router, sio, ctx, seen = platform_app(dev, os.path.join(tmp, "data"), **overrides)
    fetched = seen["out"]
    cfg = ctx.cfg
    want_cfg = dict(det_size=640, max_faces_per_frame=16, pre_nms_topk=256,
                    compute_dtype="bfloat16", delta_transfer=True)
    if not overrides and {k: getattr(cfg, k) for k in want_cfg} != want_cfg:
        raise AssertionError(f"the default config is not the throughput profile: {cfg}")
    timed = dev.type == "cuda"
    port, stop = start_server(router, sio)
    try:
        t0 = time.perf_counter()
        dry = ctx.run_scan(cfg.face_tolerance, cfg.frame_skip, 10, True)
        warm_s = time.perf_counter() - t0
        if dry["scanned"] != PLATFORM_CAMERAS:
            raise AssertionError(f"the dry scan scanned {dry['scanned']} cameras")
        enrol_score = enrol(ctx, ctx.cameras.get(0).read()[1])
        fetched.clear()
        seen["payload_bytes"].clear()
        ctx.timers.reset()
        reset_launches()
        if timed:
            torch.cuda.synchronize()
        # max_faces=16 (the engine's slots) is not the route's default of 10,
        # so no request takes a cached digest: every GET scans
        run = asyncio.run(drive_platform(port, requests, f"/camera/alerts?max_faces={cfg.max_faces_per_frame}"))
        got = launches()
        ctx.tracking._persist_pool.submit(lambda: None).result()  # the tracker's stores land
        embed = dict(ctx.engine.embed_stats)
        kept = len(fetched), len(seen["payload_bytes"])
        device, stage_device, syncs = [], {}, None
        if timed:
            # more steady scans, dry, under torch.profiler: each scan's device
            # ms (the kernels and copies of its submit_encoded) and a stage's
            _, spans, _ = program_spans(lambda: [ctx.run_scan(
                cfg.face_tolerance, cfg.frame_skip, 10, True) for _ in range(PROFILED_SCANS)])
            device, stage_device = spans.get("frp.submit_encoded", []), stage_ms(spans)
            # one more, under the sync count: its submit and fetch
            syncs = host_syncs(lambda: ctx.run_scan(cfg.face_tolerance, cfg.frame_skip, 10, True))
        del fetched[kept[0]:], seen["payload_bytes"][kept[1]:]
    finally:
        stop()
        ctx.shutdown()

    tol = cfg.face_tolerance
    camera0 = []
    for i, (scan, out) in enumerate(zip(run["scans"], fetched)):
        body = scan["body"]
        if scan["status"] != 200 or body["metadata"]["cameras_scanned"] != PLATFORM_CAMERAS:
            raise AssertionError(f"scan {i}: status {scan['status']}, metadata {body.get('metadata')}")
        if body["metadata"]["cached"] or int(out["count"].sum()) == 0:
            raise AssertionError(f"scan {i} was a cached digest or found no face")
        hits = [d["distance"] for d in body["detections"]
                if d["target"] == ENROLLED and d["camera_id"] == 0 and d["distance"] <= tol]
        if not hits:
            raise AssertionError(f"scan {i}: the enrolled face did not match on camera 0: "
                                 f"{body['detections']}")
        camera0.append(min(hits))
    if len(fetched) != requests:
        raise AssertionError(f"{len(fetched)} engine results for {requests} scans")
    n_tracking = ctx.db["tracking"].count_documents({})
    n_logged = ctx.db["logs"].count_documents({})
    if not (n_tracking and n_logged and run["alerts"]["total"] and run["pushed"]):
        raise AssertionError(f"tracking records {n_tracking}, alert logs {n_logged}, "
                             f"alerts {run['alerts']['total']}, new_alert events {len(run['pushed'])}")
    if run["delta"]["deltas"] == 0 or run["delta"]["desyncs"] != 0:
        raise AssertionError(f"delta_stats {run['delta']}")
    if timed and got != {"detection_head": requests, "warp_crops": requests, "greedy_nms": 0}:
        raise AssertionError(f"platform launches {got}, expected {requests} scans")
    shutil.rmtree(tmp, ignore_errors=True)
    stages = run["timers"]["stages"]
    faces = [int(o["count"].sum()) for o in fetched]
    host = [s["body"]["metadata"]["processing_time"] * 1e3 for s in run["scans"]]
    return dict(
        launches=got, requests=requests, warm_s=warm_s, enrol_score=enrol_score,
        faces_per_scan=float(np.mean(faces)), min_faces=min(faces),
        camera0_distance=(min(camera0), max(camera0)), tolerance=tol,
        tracking=n_tracking, logged=n_logged, alerts=run["alerts"]["total"],
        pushed=len(run["pushed"]), delta=run["delta"],
        scan_ms=float(np.median(host)), scan_ms_mean=float(np.mean(host)),
        get_ms=float(np.median([s["wall_s"] for s in run["scans"]])) * 1e3,
        device_ms=float(np.median(device)) if device else None, stage_ms=stage_device,
        payload_kb=float(np.median(seen["payload_bytes"])) / 1024,
        parts_ms={k.split(".", 1)[1]: v["mean_ms"] for k, v in stages.items() if k.startswith("scan.")},
        scans_per_s=requests / run["seconds"],
        frames_per_s=requests * PLATFORM_CAMERAS / run["seconds"],
        embed=embed, syncs=syncs,
    )


def run_platform_parity(dev, scans: int = 2, **overrides) -> dict:
    """Phase 10's cameras through a context on `dev` and one on the CPU, both
    at f32 (TF32 off), with the same face enrolled: `scans` scans each."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="frp_platform_parity_")
    overrides["compute_dtype"] = "float32"
    apps = [platform_app(d, os.path.join(tmp, str(i)), **overrides)
            for i, d in enumerate((dev, torch.device("cpu")))]
    ctxs = [a[2] for a in apps]
    try:
        # a source of its own: the cameras' sequences stay in step
        enrol(ctxs[0], SyntheticSource(*PLATFORM_SOURCE).read()[1], ctxs[1:])
        res = [[c.run_scan(c.cfg.face_tolerance, 1, c.cfg.max_faces_per_frame)
                for _ in range(scans)] for c in ctxs]
    finally:
        for c in ctxs:
            c.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    errs: dict[str, float] = {}
    for i, (a, b) in enumerate(zip(*res)):
        ta = [(d["target"], d["camera_id"]) for d in a["detections"]]
        if not ta or ta != [(d["target"], d["camera_id"]) for d in b["detections"]]:
            raise AssertionError(f"scan {i}: cuda and cpu targets differ: {a['detections']} "
                                 f"against {b['detections']}")
    for got, want in zip(apps[0][3]["out"], apps[1][3]["out"]):
        for key in ("valid", "count", "best_idx"):
            if not np.array_equal(got[key], want[key]):
                raise AssertionError(f"platform cuda and cpu scans differ in {key}")
        v = want["valid"]
        for key in ("boxes", "best_distance", "embeddings"):
            errs[key] = max(errs.get(key, 0.0), float(np.abs(got[key][v] - want[key][v]).max()))
    if not errs["boxes"] <= 1e-2:
        raise AssertionError(f"platform cuda and cpu boxes differ by {errs['boxes']} px")
    return dict(scans=scans, detections=len(res[0][-1]["detections"]), max_abs_err=errs)


# --- phase 11: the rest of the platform -------------------------------------------

VIDEO_SIZE = (1920, 1080)
VIDEO_FRAMES = 60  # 20 sampled: chunks of 8, 8 and 4
WARM_FRAMES = 12  # all sampled: chunks of 8 and 4, the same shapes
CCTV_FRAMES = 3
FL_LAYERS = {"conv": (3, 3, 16, 32), "fc": (128, 10), "bias": (10,)}


def multipart(fields: dict, files: dict) -> tuple[bytes, dict]:
    """A multipart/form-data body and its Content-Type header; `files` maps a
    field to (filename, bytes, content type)."""
    boundary = "chipsmokeboundary"
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
             for k, v in fields.items()]
    for k, (name, data, ctype) in files.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"; '
                     f'filename="{name}"\r\nContent-Type: {ctype}\r\n\r\n'.encode() + data + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def post_file(port: int, path: str, name: str, data: bytes, ctype: str) -> tuple[int, dict]:
    body, headers = multipart({}, {"file": (name, data, ctype)})
    status, _, got = asyncio.run(http_call(port, "POST", path, body, headers))
    return status, json.loads(got)


def instrument_deepfake(svc, eng) -> tuple[dict, callable]:
    """Record the deepfake path's parts on the host clock: "read" (from the
    probe to the classification: probe, seek and decode), "letterbox" (each
    build_batch_i420), "engine" (each process_frames) and every
    classify_frames call's frames and results. Returns the record and a function that undoes the wrapping."""
    rec: dict = {k: [] for k in ("read", "letterbox", "engine", "frames", "results")}
    probe, classify, process = svc.probe_video, svc.classify_frames, eng.process_frames
    letterbox = batching.build_batch_i420
    started: dict = {}

    def probe_video(path):
        started["t"] = time.perf_counter()
        return probe(path)

    def classify_frames(frames):
        if "t" in started:
            rec["read"].append(time.perf_counter() - started.pop("t"))
        out = classify(frames)
        rec["frames"].append(frames)
        rec["results"].append(out)
        return out

    def build_batch_i420(*args, **kwargs):
        t = time.perf_counter()
        out = letterbox(*args, **kwargs)
        rec["letterbox"].append(time.perf_counter() - t)
        return out

    def process_frames(*args, **kwargs):
        t = time.perf_counter()
        out = process(*args, **kwargs)
        rec["engine"].append(time.perf_counter() - t)
        return out

    svc.probe_video, svc.classify_frames, eng.process_frames = probe_video, classify_frames, process_frames
    batching.build_batch_i420 = build_batch_i420

    def undo():
        for obj, name in ((svc, "probe_video"), (svc, "classify_frames"), (eng, "process_frames")):
            delattr(obj, name)
        batching.build_batch_i420 = letterbox

    return rec, undo


def engine_batches(eng, frames: list) -> list[dict]:
    """BGR frames through eng as the deepfake service batches them: chunks of
    frames_per_batch, letterboxed to active-rows I420."""
    size, chunk, out = eng.cfg.det_size, eng.cfg.frames_per_batch, []
    for i in range(0, len(frames), chunk):
        part = frames[i:i + chunk]
        rows = batching.active_rows_for([f.shape[:2] for f in part], size)
        batch, _ = batching.build_batch_i420(dict(enumerate(part)), size, slots=len(part),
                                             active_rows=rows)
        out.append(eng.process_frames(batch, fmt="yuv420"))
    return out


BF16_TOL = dict(box_px=1.0, cos=0.99, fake_prob=0.02)
# Two anchors of one face whose scores lie this close are a near tie: a
# logit's bf16 step (2^-7 at |logit| < 4) moves a score of 0.998 by 2e-5, so
# bf16 rounding on either device can flip which one greedy suppression keeps
# (the kept box then moves by some 3 px at det 640, and the crop with it).
NEAR_TIE = 2e-4


def kept_anchors(fn, det_size: float, shards: int = 1) -> tuple[list, list, list]:
    """Run fn(), which returns a list of process_frames results, with the
    detection head's candidate payloads captured. Returns the results, per
    result [B, M, 5] the prior (cx, cy, w, h) and score of the candidate each
    slot kept (the one whose decoded box is the slot's box), and the
    payloads [B, K, 19] on the host. An engine over a mesh of `shards`
    data positions builds a payload a shard: they are joined in row
    order."""
    payloads = []
    build = detection_cuda.build_payload

    def capture(*args, **kwargs):
        payloads.append(build(*args, **kwargs))
        return payloads[-1]

    detection_cuda.build_payload = capture
    try:
        results = fn()
    finally:
        detection_cuda.build_payload = build
    if len(payloads) != shards * len(results):
        raise AssertionError(f"{len(payloads)} head payloads for {len(results)} results")
    payloads = [torch.cat(payloads[i:i + shards]) for i in range(0, len(payloads), shards)]
    anchors, hosts = [], []
    for p, out in zip(payloads, results):
        p = p.float().cpu()
        boxes = decode_boxes(p[..., 0:4], p[..., 14:18], det_size).numpy()
        idx = np.abs(boxes[:, None] - out["boxes"][:, :, None]).sum(-1).argmin(-1)  # [B, M]
        host = p.numpy()
        anchors.append(host[np.arange(len(host))[:, None], idx][..., 14:19])
        hosts.append(host)
    return results, anchors, hosts


def face_agreement(g: dict, w: dict) -> tuple[dict, np.ndarray]:
    """Per slot [B, M] of two results: box error (px), embedding cosine and
    fake_prob error of `g` against `w`, and where they agree within BF16_TOL
    (only slots valid in both can)."""
    a, b = g["embeddings"], w["embeddings"]
    with np.errstate(invalid="ignore", divide="ignore"):  # empty slots: 0 / 0
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    e = dict(box_px=np.abs(g["boxes"] - w["boxes"]).max(axis=-1), cos=cos,
             fake_prob=np.abs(g["fake_prob"] - w["fake_prob"]))
    agree = ((e["box_px"] <= BF16_TOL["box_px"]) & (e["cos"] >= BF16_TOL["cos"])
             & (e["fake_prob"] <= BF16_TOL["fake_prob"]) & g["valid"] & w["valid"])
    return e, agree


def bf16_against_cpu(card: tuple, cpu: tuple, margin: float = 0.05) -> dict:
    """The card's bf16 results against the CPU's bf16 results on the same
    batches, each a kept_anchors triple. A face agrees when its box is within
    1 px, its embedding at cosine >= 0.99 and its fake_prob within 0.02
    (BF16_TOL). Every face whose kept anchor is the same on both must agree;
    a face whose kept anchor differs (an anchor flip) must be a near tie
    (the two anchors' CPU scores within NEAR_TIE) with its fake_prob within
    0.02. best_idx is held equal on agreeing faces where the CPU's two
    nearest entries are `margin` apart; no per-frame verdict (max fake_prob
    >= 0.5) may flip. Returns the counts, the worst errors and each flip."""
    n = dict(frames=0, slots=0, valid_diff=0, count_diff=0, off_bf16=0, off_same_anchor=0,
             anchor_flips=0, flips_not_tied=0, best_idx_diff=0, best_idx_clear=0,
             best_idx_clear_diff=0, frame_verdict_flips=0)
    worst = dict(box_px=0.0, cos_min=1.0, fake_prob=0.0, distance=0.0)
    flips: list = []
    for g, ga, w, wa, wp in zip(card[0], card[1], *cpu):
        n["frames"] += len(w["count"])
        n["valid_diff"] += int((g["valid"] != w["valid"]).sum())
        n["count_diff"] += int((g["count"] != w["count"]).sum())
        v = g["valid"] & w["valid"]
        n["slots"] += int(v.sum())
        if not v.any():
            continue
        e, agree = face_agreement(g, w)
        worst["box_px"] = max(worst["box_px"], float(e["box_px"][v].max()))
        worst["cos_min"] = min(worst["cos_min"], float(e["cos"][v].min()))
        worst["fake_prob"] = max(worst["fake_prob"], float(e["fake_prob"][v].max()))
        worst["distance"] = max(worst["distance"],
                                float(np.abs(g["best_distance"][v] - w["best_distance"][v]).max()))
        same = v & (ga[..., :4] == wa[..., :4]).all(-1)
        n["off_bf16"] += int((v & ~agree).sum())
        n["off_same_anchor"] += int((same & ~agree).sum())
        for i, j in zip(*np.nonzero(v & ~same)):
            prior = (wp[i, :, 14:18] == ga[i, j, :4]).all(-1)
            gap = float(wa[i, j, 4] - wp[i, prior, 18].max()) if prior.any() else float("inf")
            tied = abs(gap) <= NEAR_TIE and e["fake_prob"][i, j] <= BF16_TOL["fake_prob"]
            n["anchor_flips"] += 1
            n["flips_not_tied"] += int(not tied)
            flips.append(dict(score_gap=gap, box_px=round(float(e["box_px"][i, j]), 3),
                              cos=round(float(e["cos"][i, j]), 4)))
        diff = v & (g["best_idx"] != w["best_idx"])
        clear = same & agree & ((w["topk_distance"][..., 1] - w["topk_distance"][..., 0]) >= margin)
        n["best_idx_diff"] += int(diff.sum())
        n["best_idx_clear"] += int(clear.sum())
        n["best_idx_clear_diff"] += int((diff & clear).sum())
        for i in range(len(w["count"])):
            if v[i].any():
                n["frame_verdict_flips"] += int(
                    (g["fake_prob"][i][v[i]].max() >= 0.5) != (w["fake_prob"][i][v[i]].max() >= 0.5))
    ok = (n["valid_diff"] == 0 and n["count_diff"] == 0 and n["off_same_anchor"] == 0
          and n["flips_not_tied"] == 0 and n["best_idx_clear_diff"] == 0
          and n["frame_verdict_flips"] == 0)
    return dict(ok=ok, **n, **worst, flips=flips)


def run_bf16_check(dev, scenes: np.ndarray, video_frames: list, **overrides) -> dict:
    """Queue 3 item 2: the default engine (bf16) on `dev` against the CPU
    engine at bf16, on the rendered scenes (RGB) and on the video's sampled
    frames (active-rows I420, as the deepfake service sends them), with a
    gallery of the faces they hold (each at its own norm) and decoys."""
    engs = [RecognitionEngine(load_config(**overrides), device=d) for d in (dev, "cpu")]
    if engs[0].cfg.compute_dtype != "bfloat16" and not overrides:
        raise AssertionError("the default config does not compute in bf16")
    ref = [engs[1].process_frames(scenes)] + engine_batches(engs[1], video_frames)
    embs = np.concatenate([o["embeddings"][o["valid"]] for o in ref])
    embs = embs * np.linspace(1.0, 0.8, len(embs), dtype=np.float32)[:, None]
    decoys = np.random.default_rng(SEED).normal(size=(3, embs.shape[1])).astype(np.float32)
    for eng in engs:
        for i, e in enumerate([*embs, *decoys]):
            eng.gallery.add(f"g{i}", e)
    res = [kept_anchors(lambda: [eng.process_frames(scenes)] + engine_batches(eng, video_frames),
                        float(eng.cfg.det_size)) for eng in engs]
    verdicts = []
    for out in (r[0] for r in res):
        probs = [float(o["fake_prob"][i][o["valid"][i]].max())
                 for o in out[1:] for i in range(len(o["count"])) if o["valid"][i].any()]
        verdicts.append("fake" if probs and np.mean(probs) >= 0.5 else "real" if probs else "no_faces")
    return dict(scenes=bf16_against_cpu(*(tuple(x[:1] for x in r) for r in res)),
                video=bf16_against_cpu(*(tuple(x[1:] for x in r) for r in res)),
                verdicts=verdicts, gallery=len(embs) + 3)


def clip_read_ms(path: str, sampled) -> dict:
    """Host ms to read a clip's sampled frames by seeking to each, as the
    deepfake service does but with cv2's own MJPEG backend, and to read every
    frame in order with cv2's default backend (the service's); with the
    sampled frames of the in-order read, to hold the service's seeks to."""
    import cv2

    cap = cv2.VideoCapture(path, cv2.CAP_OPENCV_MJPEG)
    out = {"mjpeg_backend": cap.getBackendName()}
    t = time.perf_counter()
    for i in sampled:
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(i))
        if not cap.read()[0]:
            raise AssertionError(f"frame {i} of {path} did not read")
    out["mjpeg_seek_ms"] = (time.perf_counter() - t) * 1e3
    cap.release()
    cap = cv2.VideoCapture(path)
    out["default_backend"] = cap.getBackendName()
    want, frames = {int(i) for i in sampled}, {}
    t, n = time.perf_counter(), 0
    while (got := cap.read())[0]:
        if n in want:
            frames[n] = got[1]
        n += 1
    out["in_order_ms"], out["in_order_frames"] = (time.perf_counter() - t) * 1e3, n
    cap.release()
    out["sampled_frames"] = [frames[int(i)] for i in sampled]
    return out


def run_services(dev, **overrides) -> dict:
    """Phase 11: the deepfake video, image and CCTV routes, the async search,
    federated averaging, the snapshot, /app and /dashboard on phase 10's app
    (the default config; `overrides` of it only for a rehearsal on the CPU),
    served over the socket; then the video at f32 on `dev` against the CPU,
    and the bf16 check."""
    import cv2  # the card machine has cv2: the deepfake service reads video with it

    tmp = tempfile.mkdtemp(prefix="frp_services_")
    clip, warm_clip = os.path.join(tmp, "walk.avi"), os.path.join(tmp, "warm.avi")
    t0 = time.perf_counter()
    has_face = write_face_clip(clip, *VIDEO_SIZE, VIDEO_FRAMES, seed=SEED)
    write_face_clip(warm_clip, *VIDEO_SIZE, WARM_FRAMES, seed=SEED + 1)
    write_s = time.perf_counter() - t0
    with open(clip, "rb") as f:
        clip_bytes = f.read()
    router, sio, ctx, _ = platform_app(dev, os.path.join(tmp, "data"), **overrides)
    cfg, svc = ctx.cfg, ctx.deepfake
    timed = dev.type == "cuda"
    n = svc.max_frames
    sampled = svc._sample_indices(VIDEO_FRAMES, False)
    with_face = sum(has_face[i] for i in sampled)
    rec, undo = instrument_deepfake(svc, ctx.engine)
    port, stop = start_server(router, sio)
    try:
        frame0 = ctx.cameras.get(0).read()[1]
        enrol(ctx, frame0)
        jpeg0 = cv2.imencode(".jpg", frame0)[1].tobytes()
        with open(warm_clip, "rb") as f:
            warm = post_file(port, "/deepfake/detect", "warm.avi", f.read(), "video/x-msvideo")
        if warm[0] != 200 or warm[1]["frames_sampled"] != WARM_FRAMES:
            raise AssertionError(f"the warm-up video: {warm}")
        for v in rec.values():
            v.clear()

        # the video, then the same bytes again (the dedup cache)
        reset_launches()
        if timed:
            torch.cuda.synchronize()
        t = time.perf_counter()
        status, video = post_file(port, "/deepfake/detect", "walk.avi", clip_bytes, "video/x-msvideo")
        video_wall = time.perf_counter() - t
        video_launches = launches()
        video_chunks = list(rec["frames"])
        parts = {k: float(np.sum(rec[k])) * 1e3 for k in ("read", "letterbox", "engine")}
        n_chunks = len(rec["engine"])
        if status != 200 or video["cached"] or video["frames_sampled"] != n:
            raise AssertionError(f"POST /deepfake/detect: {status} {video}")
        if video["frames_with_faces"] != with_face or "result" not in video or "confidence" not in video:
            raise AssertionError(f"{video['frames_with_faces']} frames with faces of {n} sampled, "
                                 f"{with_face} hold one: {video}")
        want = -(-n // cfg.frames_per_batch)
        if n_chunks != want or (timed and video_launches != {
                "detection_head": want, "warp_crops": want, "greedy_nms": 0}):
            raise AssertionError(f"the video took {n_chunks} chunks, launches {video_launches}")
        status, again = post_file(port, "/deepfake/detect", "walk.avi", clip_bytes, "video/x-msvideo")
        if status != 200 or not again["cached"] or launches() != video_launches:
            raise AssertionError(f"the second upload: cached {again.get('cached')}, "
                                 f"launches {launches()}")

        # one image, the CCTV sweep over the cameras, the async search
        status, image = post_file(port, "/deepfake/detect-image", "cam0.jpg", jpeg0, "image/jpeg")
        if status != 200 or image.get("faces", 0) < 1 or image["result"] not in ("real", "fake"):
            raise AssertionError(f"POST /deepfake/detect-image: {status} {image}")
        t = time.perf_counter()
        status, cctv = asyncio.run(http_get(port, f"/deepfake/cctv?max_frames={CCTV_FRAMES}"))
        cctv_s = time.perf_counter() - t
        tallies = cctv["cameras"].values()
        if status != 200 or len(cctv["cameras"]) != PLATFORM_CAMERAS or any(
                c["frames"] != CCTV_FRAMES or c["no_faces"] == CCTV_FRAMES for c in tallies):
            raise AssertionError(f"GET /deepfake/cctv: {status} {cctv}")
        status, job = post_file(port, "/async/face/search", "cam0.jpg", jpeg0, "image/jpeg")
        if status != 202:
            raise AssertionError(f"POST /async/face/search: {status} {job}")
        deadline = time.time() + 60
        while job["status"] not in ("finished", "failed") and time.time() < deadline:
            time.sleep(0.05)
            job = asyncio.run(http_get(port, f"/async/jobs/{job['job_id']}"))[1]
        best = (job.get("result") or {}).get("results", [{}])[0].get("best_match") or {}
        if job["status"] != "finished" or best.get("target") != ENROLLED:
            raise AssertionError(f"the async search: {job}")
        got_launches = launches()
        want_all = want + 1 + PLATFORM_CAMERAS + 1  # video, image, a chunk a camera, search
        if timed and got_launches != {"detection_head": want_all, "warp_crops": want_all,
                                      "greedy_nms": 0}:
            raise AssertionError(f"phase 11 launches {got_launches}, expected {want_all} each")
        chunks = []
        if timed:  # the video's chunks again under torch.profiler: each one's device ms
            _, spans, _ = program_spans(lambda: [svc.classify_frames(f) for f in video_chunks])
            chunks = spans.get("frp.process_frames", [])

        # federated averaging: two clients, then the aggregate
        rng = np.random.default_rng(SEED)
        ups = {c: {k: rng.normal(size=shape) for k, shape in FL_LAYERS.items()} for c in ("a", "b")}
        for c, w in ups.items():
            body = json.dumps({"target": c, "weights": {k: v.tolist() for k, v in w.items()}}).encode()
            status, _, got = asyncio.run(http_call(port, "POST", "/face/fl/upload_weights", body,
                                                   {"Content-Type": "application/json"}))
            if status != 200 or json.loads(got)["status"] != "success":
                raise AssertionError(f"FL upload {c}: {status} {got[:200]}")
        status, _, agg = asyncio.run(http_call(port, "POST", "/face/fl/aggregate", b"{}",
                                               {"Content-Type": "application/json"}))
        model = asyncio.run(http_get(port, "/face/fl/global_model"))[1]
        if status != 200 or json.loads(agg)["aggregation_details"]["clients_aggregated"] != 2:
            raise AssertionError(f"FL aggregate: {status} {agg[:200]}")
        for k in FL_LAYERS:
            mean = ups["a"][k] * 0.5 + ups["b"][k] * 0.5
            if not np.array_equal(np.asarray(model["weights"][k]), mean):
                raise AssertionError(f"the FL global model's {k} is not the numpy mean")

        # the snapshot (200 with an ETag, then 304), /app and /dashboard
        status, head, jpeg = asyncio.run(http_call(port, "GET", "/api/camera/0/snapshot"))
        status2, _, empty = asyncio.run(http_call(port, "GET", "/api/camera/0/snapshot",
                                                  headers={"If-None-Match": head.get("etag", "")}))
        if status != 200 or not head.get("etag") or not jpeg.startswith(b"\xff\xd8") \
                or status2 != 304 or empty:
            raise AssertionError(f"snapshot: {status} {head}, then {status2}")
        pages = {p: asyncio.run(http_call(port, "GET", p)) for p in ("/app", "/dashboard")}
        if any(st != 200 or b"<html" not in body.lower() for st, _, body in pages.values()):
            raise AssertionError(f"pages: { {p: r[0] for p, r in pages.items()} }")
        stats = asyncio.run(http_get(port, "/deepfake/stats"))[1]
        if stats["total_videos"] != 2:
            raise AssertionError(f"/deepfake/stats: {stats}")
    finally:
        undo()
        stop()
        ctx.shutdown()

    reads = clip_read_ms(clip, sampled)

    # the video at f32 on dev against the CPU: every sampled frame, the verdict
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = []
    for i, d in enumerate((dev, torch.device("cpu"))):
        _, _, c, _ = platform_app(d, os.path.join(tmp, f"f32_{i}"), **{**overrides, "compute_dtype": "float32"})
        r, u = instrument_deepfake(c.deepfake, c.engine)
        try:
            out = c.deepfake.process_video(clip)
        finally:
            u()
            c.shutdown()
        f32.append((out, [x for part in r["results"] for x in part], r["frames"]))
    (g, gframes, frames), (w, wframes, _) = f32
    frames = [f for part in frames for f in part]
    # cv2's seeks gave the service the frames an in-order read gives
    in_order = reads.pop("sampled_frames")
    if len(frames) != len(in_order) or any(not np.array_equal(a, b) for a, b in zip(frames, in_order)):
        raise AssertionError("the service's seeks read other frames than an in-order read")
    perr = dict(fake_prob=0.0, box_px=0.0)
    if not len(gframes) == len(wframes) == n or g["result"] != w["result"]:
        raise AssertionError(f"f32 video: {g['result']} on {dev}, {w['result']} on the CPU")
    for i, (a, b) in enumerate(zip(gframes, wframes)):
        if a["faces"] != b["faces"] or (a["fake_prob"] is None) != (b["fake_prob"] is None):
            raise AssertionError(f"f32 frame {i}: {a} on {dev}, {b} on the CPU")
        if a["fake_prob"] is not None:
            perr["fake_prob"] = max(perr["fake_prob"], abs(a["fake_prob"] - b["fake_prob"]))
            perr["box_px"] = max(perr["box_px"], float(np.abs(np.subtract(a["boxes"], b["boxes"])).max()))
    if perr["fake_prob"] > 1e-3 or perr["box_px"] > 1e-2:
        raise AssertionError(f"f32 video frames differ: {perr}")

    bf16 = run_bf16_check(dev, render_scenes(FRAMES, cfg.det_size, SEED), frames, **overrides)
    shutil.rmtree(tmp, ignore_errors=True)
    if not (bf16["scenes"]["ok"] and bf16["video"]["ok"]):
        raise AssertionError(f"bf16 on {dev} against the CPU at bf16: {bf16}")
    return dict(
        launches=got_launches, video_launches=video_launches, write_s=write_s,
        clip_mb=len(clip_bytes) / 1e6, reads=reads,
        video=video, chunks=n_chunks, video_wall_ms=video_wall * 1e3,
        video_ms=video["processing_time"] * 1e3, parts_ms=parts,
        chunk_device_ms=chunks, cctv_ms=cctv_s * 1e3, cctv=cctv["cameras"],
        image=image, job_distance=best["distance"], fl_layers=len(FL_LAYERS),
        f32=dict(result=g["result"], confidence=(g["confidence"], w["confidence"]),
                 mean=(g["statistics"].get("mean_fake_probability"),
                       w["statistics"].get("mean_fake_probability")), **perr),
        bf16=bf16,
    )


# --- phase 12: training --------------------------------------------------------

TRAIN_IDS = 64  # tools/pretrain_embedder.py's defaults: 64 identities, batch 64,
TRAIN_BATCH = 64  # lr 0.05, margin 0.5, bf16
TRAIN_LR = 0.05
TRAIN_STEPS = 20
TRAIN_WARM = 3
BIG_BATCH = 256  # iresnet18 again at this batch: where the arithmetic starts to bind
DET_TRAIN = (320, 16)  # tools/pretrain_synthetic.py's det size and batch
PARITY_BATCH = 8
PARITY_LR = {"arcface": 1e-4, "adamw": 1e-3}


def arcface_batch(batch: int, seed: int) -> tuple[np.ndarray, np.ndarray, float]:
    """(uint8 crops [B, 112, 112, 3], labels, host ms to render them): the
    tool's crops (make_identity_crop, then jitter_crop) of TRAIN_IDS
    identities, rounded back to uint8."""
    from frp_tpu_torch.train.pairs import jitter_crop
    from frp_tpu_torch.train.synthetic import make_identity, make_identity_crop

    identities = [make_identity(s) for s in range(TRAIN_IDS)]
    rng = np.random.default_rng(seed)
    t = time.perf_counter()
    labels = rng.integers(0, TRAIN_IDS, size=(batch,)).astype(np.int64)
    crops = np.stack([jitter_crop(make_identity_crop(identities[l], rng, difficulty="mix"), rng)
                      for l in labels])
    ms = (time.perf_counter() - t) * 1e3
    return np.clip(np.rint(crops), 0, 255).astype(np.uint8), labels, ms


def timed_steps(step, steps: int, warm: int) -> dict:
    """Run step() `steps` times, each between CUDA events and then
    synchronized; the medians after `warm` steps on both clocks."""
    dev_ms, host_ms = [], []
    for _ in range(steps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        e0.record()
        step()
        e1.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t) * 1e3)
        dev_ms.append(e0.elapsed_time(e1))
    return dict(ms=float(np.median(dev_ms[warm:])), host_ms=float(np.median(host_ms[warm:])))


def step_work(step, n_params: int, in_bytes: int, opt_buffers: int) -> dict:
    """FLOPs of one step as FlopCounterMode counts them (forward and
    backward), the bytes it must move at least (the batch read once; each
    parameter read by the forward, its gradient written by the backward,
    parameter, gradient and optimizer buffers read and parameter and buffers
    written by the update), and the bound: the larger of the FLOPs over the
    bf16 peak and the bytes over the memory rate."""
    flops = counted_flops(step)
    torch.cuda.synchronize()
    nbytes = in_bytes + 4 * n_params * (1 + 1 + (2 + opt_buffers) + (1 + opt_buffers))
    tb, to = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS_BF16
    return dict(flops=flops, bytes=nbytes, bound_ms=max(tb, to) * 1e3,
                bound_by="bytes" if tb >= to else "operations")


def train_run(trainer, step, losses, n_params: int, in_bytes: int, opt_buffers: int,
              images: int) -> dict:
    """Time TRAIN_STEPS steps, check the loss falls, count the work, trace
    the device-busy time; `losses()` reads the run's losses."""
    t = timed_steps(step, TRAIN_STEPS, TRAIN_WARM)
    got = losses()
    if not (np.isfinite(got).all() and got[-1] < got[0]):
        raise AssertionError(f"{type(trainer).__name__}: the loss did not fall: {got}")
    work = step_work(step, n_params, in_bytes, opt_buffers)
    busy, top = busy_ms(step, 2)
    return dict(**t, **work, loss=(float(got[0]), float(got[-1])), busy_ms=busy, top=top,
                idle=None if busy is None else 1 - busy / t["host_ms"],
                share=work["bound_ms"] / t["ms"], images_per_s=images / t["host_ms"] * 1e3,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def run_arcface_train(dev, arch: str, batch: int) -> dict:
    """ArcFace on one fixed batch at the tool's settings: step ms, images/s,
    FLOPs, bound, its share, device-busy ms and idle share, peak memory."""
    from frp_tpu_torch.train.arcface import ArcFaceTrainer, leaves

    crops, labels, render_ms = arcface_batch(batch, SEED)
    torch.cuda.reset_peak_memory_stats()
    tr = ArcFaceTrainer(num_classes=TRAIN_IDS, seed=SEED, learning_rate=TRAIN_LR, arch=arch,
                        margin=0.5, device=dev)
    x, y = torch.from_numpy(crops).to(dev), torch.from_numpy(labels).to(dev)

    def losses():
        return [e["loss"] for e in tr.flush_metrics()]

    out = train_run(tr, lambda: tr.train_step(x, y, sync=False), losses,
                    sum(p.numel() for p in leaves(tr.state["params"])), crops.nbytes, 1, batch)
    tr.flush_metrics()
    return dict(out, render_ms=render_ms, trainer=tr, crops=crops, labels=labels)


def run_spoof_train(dev) -> dict:
    from frp_tpu_torch.tools.pretrain_spoof import make_spoof_batch
    from frp_tpu_torch.train.arcface import leaves
    from frp_tpu_torch.train.classifier import SpoofTrainer
    from frp_tpu_torch.train.synthetic import make_identity

    t = time.perf_counter()
    crops, labels = make_spoof_batch([make_identity(s) for s in range(32)],
                                     np.random.default_rng(SEED), TRAIN_BATCH)
    render_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.reset_peak_memory_stats()
    tr = SpoofTrainer(seed=SEED, learning_rate=1e-3, device=dev)
    x, y = torch.from_numpy(crops).to(dev), torch.from_numpy(labels).long().to(dev)
    out = train_run(tr, lambda: tr.train_step(x, y), lambda: [e["loss"] for e in tr.history],
                    sum(p.numel() for p in leaves(tr.state["params"])), crops.nbytes, 2, TRAIN_BATCH)
    return dict(out, render_ms=render_ms)


def run_detector_train(dev) -> dict:
    from frp_tpu_torch.train.arcface import leaves
    from frp_tpu_torch.train.detector import DetectorTrainer
    from frp_tpu_torch.train.synthetic import make_batch

    det, b = DET_TRAIN
    t = time.perf_counter()
    imgs, boxes, ldms, valid = make_batch(b, det, np.random.default_rng(SEED), difficulty="mix")
    render_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.reset_peak_memory_stats()
    tr = DetectorTrainer(det_size=det, seed=SEED, learning_rate=1e-3, device=dev)
    batch = [torch.from_numpy(a).to(dev) for a in (imgs, boxes, ldms, valid)]
    out = train_run(tr, lambda: tr.train_step(*batch), lambda: [e["loss"] for e in tr.history],
                    sum(p.numel() for p in leaves(tr.state["params"])), imgs.nbytes, 2, b)
    return dict(out, render_ms=render_ms)


def _tree_of(tr, fn):
    """The trainer's parameter tree with fn(param) at each leaf."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items() if not k.startswith("_")}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return None if node is None else fn(node)
    return walk(tr.state["params"])


def _flat_numpy(tree) -> dict:
    from frp_tpu_torch.models.params import flatten_params

    return {k: v.detach().cpu().numpy() for k, v in flatten_params(tree).items()}


def train_parity(dev, names=None) -> dict:
    """One step of each trainer at f32 (TF32 off) on dev and on the CPU from
    the same seed and batch: the loss within 1e-4 relative, the accuracy
    equal, every updated parameter and running stat within 1e-4 absolute;
    each optimizer buffer (the step's gradient, its square for AdamW) within
    2e-2 of its leaf's L2 norm plus 1e-3 of the tree's largest entry, as
    tests/test_torch_train.py holds the ArcFace momentum against JAX. At a
    learning rate of 1e-4 for ArcFace: its f32 gradient at a random init is
    ill-conditioned (the port's f32 step moves up to 6 % of a leaf's update
    from its f64 step), so a larger step would move the parameters apart by
    more than the bound. Returns the max errors by trainer (those of
    `names`, or all)."""
    from frp_tpu_torch.tools.pretrain_spoof import make_spoof_batch
    from frp_tpu_torch.train.arcface import ArcFaceTrainer
    from frp_tpu_torch.train.classifier import SpoofTrainer
    from frp_tpu_torch.train.detector import DetectorTrainer
    from frp_tpu_torch.train.synthetic import make_batch, make_identity

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    crops, labels, _ = arcface_batch(PARITY_BATCH, SEED + 1)
    spoof = make_spoof_batch([make_identity(s) for s in range(32)], np.random.default_rng(SEED + 2),
                             PARITY_BATCH)
    det = make_batch(4, DET_TRAIN[0], np.random.default_rng(SEED + 3), difficulty="mix")
    cases = {
        "arcface_mobilefacenet": (lambda d: ArcFaceTrainer(
            num_classes=TRAIN_IDS, seed=SEED, learning_rate=PARITY_LR["arcface"],
            compute_dtype="float32", device=d), (crops, labels), ("momentum_buffer",)),
        "arcface_iresnet18": (lambda d: ArcFaceTrainer(
            num_classes=TRAIN_IDS, seed=SEED, learning_rate=PARITY_LR["arcface"],
            compute_dtype="float32", arch="iresnet18", device=d), (crops, labels), ("momentum_buffer",)),
        "spoof": (lambda d: SpoofTrainer(seed=SEED, learning_rate=PARITY_LR["adamw"],
                                         compute_dtype="float32", device=d), spoof,
                  ("exp_avg", "exp_avg_sq")),
        "detector": (lambda d: DetectorTrainer(det_size=DET_TRAIN[0], seed=SEED,
                                               learning_rate=PARITY_LR["adamw"],
                                               compute_dtype="float32", device=d), det,
                     ("exp_avg", "exp_avg_sq")),
    }
    out = {}
    for name, (make, batch, buffers) in cases.items():
        if names is not None and name not in names:
            continue
        runs = []
        for d in (dev, torch.device("cpu")):
            tr = make(d)
            m = tr.train_step(*batch)
            bufs = {key: _flat_numpy(_tree_of(tr, lambda p: tr.optimizer.state[p][key]))
                    for key in buffers}
            runs.append((m, _flat_numpy(tr.state["params"]), bufs))
        out[name] = hold_step(name, *runs, f"{dev}", "the CPU")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False  # torch's default
    return out


def hold_step(name: str, got: tuple, want: tuple, got_on: str, want_on: str) -> dict:
    """One trainer step (metrics, flat parameters, {buffer name: flat
    buffers}) held against another's from the same state, with
    train_parity's bounds; returns the max errors, raises past a bound."""
    (mg, pg, bg), (mw, pw, bw) = got, want
    if abs(mg["loss"] - mw["loss"]) > 1e-4 * abs(mw["loss"]) or \
            mg.get("accuracy") != mw.get("accuracy"):
        raise AssertionError(f"{name}: {mg} on {got_on}, {mw} on {want_on}")
    lr = PARITY_LR["arcface" if name.startswith("arcface") else "adamw"]
    errs = dict(loss_rel=abs(mg["loss"] - mw["loss"]) / abs(mw["loss"]), params=0.0)
    # AdamW's first update is lr * g / (|g| + eps), +-lr whatever |g|: an
    # element whose gradient the two devices disagree on by more than
    # half its size (the f32 floor: 1e-6 noise on the input moves 174-277
    # of the detector's 433,200 so), or whose gradient on either device
    # is within 100 eps of zero (where g / (|g| + eps) still moves with
    # |g|), may land up to 2 lr apart; exp_avg is 0.1 g after one step
    undetermined = {
        k: (np.abs(bg["exp_avg"][k] - w) > 0.5 * np.abs(w))
        | (np.minimum(np.abs(bg["exp_avg"][k]), np.abs(w)) < 1e-7)
        for k, w in bw["exp_avg"].items()} if "exp_avg" in bw else {}
    loose, worst = 0, None
    for k, w in pw.items():
        diff = np.abs(pg[k] - w)
        if k in undetermined:
            u = undetermined[k]
            loose += int((u & (diff > 1e-4)).sum())
            if (diff[u] > 2 * lr + 1e-6).any():
                raise AssertionError(f"{name} {k}: an element moved past 2 lr")
            diff = np.where(u, 0.0, diff)
        if float(diff.max()) > errs["params"]:
            i = np.unravel_index(int(diff.argmax()), diff.shape)
            errs["params"], worst = float(diff.max()), (k, i, *(
                float(b[key][k][i]) for b in (bg, bw) for key in b))
    errs["loose"] = loose  # elements held within 2 lr only
    if errs["params"] > 1e-4 or loose > 1e-3 * sum(v.size for v in pw.values()):
        raise AssertionError(f"{name}: parameters {errs['params']:.3g} apart ({loose} loose); "
                             f"the worst element and its buffers on {got_on} and {want_on}: "
                             f"{worst}")
    for key in bw:  # each leaf within 2e-2 of its L2 norm + 1e-3 of the largest entry
        top = max(float(np.abs(v).max()) for v in bw[key].values())
        worst = 0.0
        for k, w in bw[key].items():
            err = float(np.linalg.norm(bg[key][k] - w) / (np.linalg.norm(w) + 1e-3 * top))
            worst = max(worst, err)
            if err > 2e-2:
                raise AssertionError(f"{name} {key} {k}: {err:.3g} of its L2 norm")
        errs[key] = worst
    return errs


def run_trained_serving(dev, scenes: np.ndarray, trained, default_eng: RecognitionEngine) -> dict:
    """The trained MobileFaceNet saved with save_params beside the shipped
    detector and spoof weights; an engine on them: process_frames over the
    8 scenes (valid and count equal to the default engine's: the detector is
    the same; kernels 1 and 2 launched once), then train.pairs.embed_scenes
    through it."""
    from frp_tpu_torch.models.params import save_params
    from frp_tpu_torch.train.pairs import embed_scenes

    wd = tempfile.mkdtemp(prefix="frp_trained_")
    try:
        save_params(os.path.join(wd, "mobilefacenet.npz"), trained.embedder_params())
        for name in ("retinaface_synthetic.npz", "spoof.npz"):
            shutil.copy(os.path.join("weights", name), os.path.join(wd, name))
        eng = RecognitionEngine(load_config(**PROFILE, weights_dir=wd), device=dev)
        if eng.weights_loaded["embedder"] != os.path.join(wd, "mobilefacenet.npz"):
            raise AssertionError(f"the engine loaded {eng.weights_loaded}")
        batch = tick_batch(scenes, TICKS)
        want = default_eng.process_frames(batch, fmt="yuv420")
        reset_launches()
        got = eng.process_frames(batch, fmt="yuv420")
        once = launches()
        if dev.type == "cuda" and once != {"detection_head": 1, "warp_crops": 1, "greedy_nms": 0}:
            raise AssertionError(f"process_frames launched {once}")
        for key in ("valid", "count"):
            if not np.array_equal(got[key], want[key]):
                raise AssertionError(f"the trained embedder's engine differs in {key}")
        v = got["valid"]
        emb = got["embeddings"][v]
        if not (np.isfinite(emb).all() and np.allclose(np.linalg.norm(emb, axis=-1), eng.distance_scale,
                                                        rtol=1e-2)):
            raise AssertionError("the trained embedder's embeddings are not unit-scale")
        bgr = [np.ascontiguousarray(s[..., ::-1]) for s in scenes]
        embs, labels = embed_scenes(eng, bgr, np.arange(len(bgr)))
        if embs.shape != (len(labels), 128) or len(labels) < len(bgr) - 2:
            raise AssertionError(f"embed_scenes: {embs.shape} for {len(labels)} of {len(bgr)} scenes")
        # the default engine's embeddings differ: the trained weights served
        moved = float(np.abs(emb - want["embeddings"][v]).max())
        if moved < 1e-3:
            raise AssertionError("the trained engine's embeddings equal the shipped weights'")
        return dict(faces=int(v.sum()), scenes=len(labels), launches=launches(), moved=moved,
                    scale=eng.distance_scale)
    finally:
        shutil.rmtree(wd, ignore_errors=True)


def run_fl_producer(dev, steps: int = 5, client_args: tuple = ()) -> dict:
    """Two fl_client runs on dev upload their weights_delta to the port's
    server, the second asks for the aggregate: the global model equals the
    numpy mean of the two deltas bit for bit, under the JAX package's layer
    names (frp_tpu/train/arcface.py::_flatten_tree's, which
    train.arcface.flatten_tree gives)."""
    from frp_tpu_torch.models.mobilefacenet import init_mobilefacenet
    from frp_tpu_torch.tools import fl_client
    from frp_tpu_torch.train.arcface import flatten_tree

    tmp = tempfile.mkdtemp(prefix="frp_fl_")
    router, sio, ctx, _ = platform_app(dev, os.path.join(tmp, "data"))
    port, stop = start_server(router, sio)
    try:
        t = time.perf_counter()
        runs = [fl_client.main(["--url", f"http://127.0.0.1:{port}", "--client-id", c,
                                "--steps", str(steps), "--seed", str(s), "--device", dev.type,
                                *client_args] + (["--aggregate"] if c == "site_b" else []))
                for s, c in ((1, "site_a"), (2, "site_b"))]
        seconds = time.perf_counter() - t
        status, model = asyncio.run(http_get(port, "/face/fl/global_model"))
    finally:
        stop()
        ctx.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    names = set(flatten_tree(init_mobilefacenet(0)))
    a, b = runs[0]["delta"], runs[1]["delta"]
    if status != 200 or set(a) != names or set(b) != names or set(model["weights"]) != names:
        raise AssertionError(f"FL: status {status}, layer names differ from the JAX package's")
    if runs[1]["aggregate"].get("status") != "success":
        raise AssertionError(f"FL aggregate: {runs[1]['aggregate']}")
    for k in names:
        mean = np.asarray(a[k], np.float64) * 0.5 + np.asarray(b[k], np.float64) * 0.5
        if not np.array_equal(np.asarray(model["weights"][k]), mean):
            raise AssertionError(f"the FL global model's {k} is not the numpy mean of the deltas")
    return dict(layers=len(names), params=int(sum(v.size for v in a.values())), seconds=seconds,
                losses=[[h["loss"] for h in r["history"]] for r in runs])


def run_train(dev, scenes: np.ndarray, default_eng: RecognitionEngine,
              fl_args: tuple = ()) -> dict:
    """Phase 12: the three trainers at full width, their parity with the CPU,
    the trained embedder serving, the FL producer (`fl_args` are extra
    fl_client arguments, for a rehearsal on the CPU only)."""
    reset_launches()
    seconds, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        seconds[name], t = time.perf_counter() - t, time.perf_counter()

    arc = {"mobilefacenet": run_arcface_train(dev, "mobilefacenet", TRAIN_BATCH),
           "iresnet18": run_arcface_train(dev, "iresnet18", TRAIN_BATCH),
           f"iresnet18_b{BIG_BATCH}": run_arcface_train(dev, "iresnet18", BIG_BATCH)}
    lap("arcface")
    spoof, det = run_spoof_train(dev), run_detector_train(dev)
    lap("spoof and detector")
    parity = train_parity(dev)
    lap("parity")
    serve = run_trained_serving(dev, scenes, arc["mobilefacenet"]["trainer"], default_eng)
    lap("serving")
    fl = run_fl_producer(dev, client_args=fl_args)
    lap("FL")
    return dict(arcface=arc, spoof=spoof, detector=det, parity=parity, serve=serve, fl=fl,
                launches=launches(), seconds=seconds)


# --- phase 13: a site's own weights -------------------------------------------

IMPORTED = {**PROFILE, "embedder_arch": "iresnet50", "embed_dim": 512}
W600K_SEED = 12
# calibrate_embedder and tiered_eval at 3 identities x 2 variants (their
# defaults 24 x 6 and 20 x 4 are minutes of rendering and scanning)
TOOL_SIZE = ("--identities", "3", "--variants", "2")
TOOL_TIMEOUT = 600
PARITY_SCENES = [5, 6]  # the scenes of phase 13's f32 parity: two faces each at det 640


def write_weights_dirs(root: str) -> dict:
    """Two weights dirs under root. "mixed": a seeded w600k-style
    embedder.onnx (iresnet50, 512-d, BN folded, numeric names shuffled,
    float32 raw_data as torch.onnx writes it) beside the shipped detector and spoof npz.
    "onnx": the same embedder.onnx with retinaface.onnx and spoof.onnx
    written from the shipped npz (det-style and torchvision-style graphs).
    Returns the dirs and the host seconds the writing took."""
    from frp_tpu_torch.models.params import load_params
    from frp_tpu_torch.testing import onnx_export as ox

    t = time.perf_counter()
    dirs = {k: os.path.join(root, k) for k in ("mixed", "onnx")}
    for d in dirs.values():
        os.makedirs(d)
    emb = ox.w600k_style(seed=W600K_SEED, variant=IMPORTED["embedder_arch"],
                         embed_dim=IMPORTED["embed_dim"], fp16=False)
    for d in dirs.values():
        with open(os.path.join(d, "embedder.onnx"), "wb") as f:
            f.write(emb)
    for name in ("retinaface_synthetic.npz", "spoof.npz"):
        shutil.copy(os.path.join("weights", name), os.path.join(dirs["mixed"], name))
    rng = np.random.default_rng(W600K_SEED)
    det = ox.retinaface_graph(load_params(os.path.join("weights", "retinaface_synthetic.npz")), rng)
    spoof = ox.mobilenetv3_graph(load_params(os.path.join("weights", "spoof.npz")), rng)
    for name, data in (("retinaface.onnx", det), ("spoof.onnx", spoof)):
        with open(os.path.join(dirs["onnx"], name), "wb") as f:
            f.write(data)
    return dict(dirs=dirs, write_s=time.perf_counter() - t, embedder_mb=len(emb) / 1e6)


def start_tool(name: str, args: list, env: dict) -> dict:
    """python -m frp_tpu_torch.tools.<name> in a child process from the
    repository root, with a thread that collects its output and its wall
    seconds when it exits (killed at TOOL_TIMEOUT)."""
    proc = subprocess.Popen([sys.executable, "-m", f"frp_tpu_torch.tools.{name}", *args],
                            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    run = dict(name=name, t0=time.perf_counter())

    def wait():
        try:
            run["out"], run["err"] = proc.communicate(timeout=TOOL_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            run["out"], run["err"] = proc.communicate()
            run["timeout"] = True
        run.update(rc=proc.returncode, seconds=time.perf_counter() - run["t0"])

    run["thread"] = threading.Thread(target=wait, daemon=True)
    run["thread"].start()
    return run


def finish_tool(run: dict) -> dict:
    """Wait for a start_tool child: its exit code, wall seconds and output."""
    run["thread"].join()
    if run.get("timeout"):
        raise AssertionError(f"{run['name']} did not finish in {TOOL_TIMEOUT} s: {run['err'][-2000:]}")
    return run


def run_tools(dev, dirs: dict, tmp: str) -> list:
    """Start the weights tools on dev, all at once: import_real_weights
    --dry-run on the detector and spoof exports (passes) and on the 512-d
    embedder (refused: the tool validates embedders at 128-d, as the JAX
    package's does), calibrate_embedder and tiered_eval over the mixed dir
    (WEIGHTS_DIR, EMBED_DIM=512) at TOOL_SIZE."""
    env = dict(os.environ, WEIGHTS_DIR=dirs["mixed"], EMBED_DIM=str(IMPORTED["embed_dim"]))
    env.pop("CONV_PADDING", None)
    dev_arg = ["--device", dev.type]
    arch = ["--arch", IMPORTED["embedder_arch"]]
    onnx = dirs["onnx"]
    return [
        start_tool("import_real_weights", ["--detector", os.path.join(onnx, "retinaface.onnx"),
                                           "--spoof", os.path.join(onnx, "spoof.onnx"),
                                           "--dry-run", *dev_arg], env),
        start_tool("import_real_weights", ["--embedder", os.path.join(onnx, "embedder.onnx"),
                                           *arch, "--dry-run", *dev_arg], env),
        start_tool("calibrate_embedder", [*arch, *TOOL_SIZE, *dev_arg,
                                          "--out", os.path.join(tmp, "calibration.json")], env),
        start_tool("tiered_eval", [*arch, *TOOL_SIZE, *dev_arg,
                                   "--out", os.path.join(tmp, "tiered_eval.json")], env),
    ]


def check_tools(dev, started: list, tmp: str) -> dict:
    """Wait for run_tools' children and hold their results."""
    dry, dry512, cal, tiered = (finish_tool(s) for s in started)
    for name, r in (("import_real_weights --dry-run", dry), ("calibrate_embedder", cal),
                    ("tiered_eval", tiered)):
        if r["rc"] != 0:
            raise AssertionError(f"{name} exited {r['rc']}: {r['err'][-3000:]}")
    if "dry run: validation passed" not in dry["out"]:
        raise AssertionError(f"import_real_weights --dry-run: {dry['out']}")
    if dry512["rc"] == 0 or "shape mismatch" not in dry512["err"]:
        raise AssertionError(f"the 512-d embedder was not refused at 128-d: {dry512['err'][-2000:]}")
    with open(os.path.join(tmp, "calibration.json")) as f:
        calj = json.load(f)
    with open(os.path.join(tmp, "tiered_eval.json")) as f:
        tierj = json.load(f)
    for name, j in (("calibration", calj), ("tiered_eval", tierj)):
        if j["weights_file"] != "embedder.onnx" or not j["backend"].startswith(dev.type):
            raise AssertionError(f"{name}: weights {j['weights_file']}, backend {j['backend']}")
    scale = calj["distance_scale"]
    if not (np.isfinite(scale) and scale > 0):
        raise AssertionError(f"calibration scale {scale}")
    recall = {t: v["detector_recall"] for t, v in tierj["tiers"].items()}
    if not any(recall.values()):
        raise AssertionError(f"tiered_eval detected no scene: {recall}")
    refused = dry512["err"].strip().splitlines()[-1]
    return dict(seconds={"dry-run": dry["seconds"], "dry-run 512-d": dry512["seconds"],
                         "calibrate_embedder": cal["seconds"], "tiered_eval": tiered["seconds"]},
                scale=scale, detected=calj["detected_scenes"], recall=recall,
                backend=calj["backend"], refused=refused)


def scan_stream(eng: RecognitionEngine, scenes: np.ndarray, ticks: int, warm: int) -> dict:
    """Phase 4's delta stream through eng, submit then fetch: ms/batch on the
    host clock and per-stage device ms over ticks[warm:], faces a batch."""
    enc = DeltaEncoder(block_bytes=128)
    payloads = [enc.encode(tick_batch(scenes, t)) for t in range(ticks + 1)]
    r = stream_ms(eng, payloads, warm)
    return dict(r, batches=2 * len(payloads))


def run_imported(dev, scenes: np.ndarray, ticks: int, warm: int) -> dict:
    """Phase 13: a site's own weights on the card (see the module doc)."""
    from frp_tpu_torch.models import nn

    tmp = tempfile.mkdtemp(prefix="frp_import_")
    try:
        made = write_weights_dirs(tmp)
        dirs = made["dirs"]
        started = run_tools(dev, dirs, tmp)
        if nn._PADDING_MODE != "same":
            raise AssertionError(f"padding mode {nn._PADDING_MODE} before phase 13")
        mixed = {**IMPORTED, "weights_dir": dirs["mixed"]}
        allx = {**IMPORTED, "weights_dir": dirs["onnx"]}
        # untimed checks first, while the tools run: f32 parity of both
        # engines against the CPU, and the mixed engine at bf16
        par = {"mixed": run_parity(dev, scenes[PARITY_SCENES], {**mixed, "max_faces_per_frame": 4})}
        if nn._PADDING_MODE != "same":
            raise AssertionError("the mixed engines switched the padding mode")
        bf16 = run_bf16_check(dev, scenes, [], **mixed)["scenes"]
        if not bf16["ok"]:
            raise AssertionError(f"imported bf16 engine against the cpu at bf16: {bf16}")
        par["onnx"] = run_parity(dev, scenes[PARITY_SCENES], {**allx, "max_faces_per_frame": 4})
        if nn._PADDING_MODE != "torch":
            raise AssertionError("the all-ONNX engines did not switch to torch padding")
        nn.set_padding_mode("same")
        tools = check_tools(dev, started, tmp)

        # (a) mixed provenance over phase 4's stream: the scan with its checks
        scan = run_scan(dev, scenes, mixed, ticks, warm)
        eng = scan["engine"]
        if (eng.weights_loaded["embedder"] != os.path.join(dirs["mixed"], "embedder.onnx")
                or not eng.weights_loaded["detector"].endswith(".npz") or eng.distance_scale != 1.0
                or nn._PADDING_MODE != "same"):
            raise AssertionError(f"mixed engine: {eng.weights_loaded}, scale {eng.distance_scale}, "
                                 f"padding {nn._PADDING_MODE}")
        comp = compaction_runs(dev, scenes, mixed, eng, ticks, warm, rounds=1)
        n_batches = scan["batches"] + comp["batches"]
        # (b) all three from ONNX: torch padding
        engb = RecognitionEngine(load_config(**allx), device=dev)
        if nn._PADDING_MODE != "torch" or not all(
                p.endswith(".onnx") for p in engb.weights_loaded.values()):
            raise AssertionError(f"all-ONNX engine: {engb.weights_loaded}, padding {nn._PADDING_MODE}")
        onnx_scan = scan_stream(engb, scenes, ticks, warm)
        n_batches += onnx_scan["batches"]
        got = launches()
        want = {"detection_head": n_batches, "warp_crops": n_batches, "greedy_nms": 0}
        if dev.type == "cuda" and got != want:
            raise AssertionError(f"phase 13 launches {got}, expected {want}")
        return dict(scan=scan, compaction=comp, onnx_scan=onnx_scan, parity=par, bf16=bf16,
                    tools=tools, launches=got, batches=n_batches, write_s=made["write_s"],
                    chains=chain_launches(dev),
                    embedder_mb=made["embedder_mb"])
    finally:
        nn.set_padding_mode("same")
        shutil.rmtree(tmp, ignore_errors=True)


# --- main --------------------------------------------------------------------

# --- phase 14: the mesh -------------------------------------------------------

MESH_DATA = 2  # phase 14 (a): the card repeated twice on the data axis
MESH_RANKS, MESH_MODEL = 4, 2  # phase 14 (b): a 2 x 2 process mesh sharing the card
MESH_STEPS = 6  # (b)'s and (c)'s bf16 steps, the median after TRAIN_WARM


def host_syncs(fn) -> int:
    """The synchronizing CUDA calls fn() makes (each a wait of the host for
    the card), as torch's sync debug mode reports them. Its first use in a
    process also warns that the mode is a prototype, a notice that is no
    sync and is not counted."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def enrol_faces(engines: list, frames: np.ndarray, fmt: str = "rgb") -> int:
    """The faces the last engine finds in frames, each at its own norm, and 3
    decoys, enrolled in every engine's gallery; returns the count."""
    ref = engines[-1].process_frames(frames, fmt=fmt)
    embs = ref["embeddings"][ref["valid"]]
    embs = embs * np.linspace(0.95, 0.8, len(embs), dtype=np.float32)[:, None]
    decoys = np.random.default_rng(SEED).normal(size=(3, embs.shape[1])).astype(np.float32)
    for eng in engines:
        for i, e in enumerate([*embs, *decoys]):
            eng.gallery.add(f"g{i}", e)
    return len(embs) + 3


def run_mesh_engine(dev, scenes: np.ndarray, ticks: int, warm: int) -> dict:
    """Phase 14 (a): the default profile over a mesh of the card repeated
    MESH_DATA times, over phase 4's stream: kernels 1 and 2 once a shard a
    batch, the resident batch, ms/batch, and the host syncs a batch beside
    an unsharded engine's. Then against the unsharded engine on the same
    inputs: at bf16 by the NEAR_TIE rule (the scenes as RGB and the last
    tick as I420), at f32 (TF32 off) bit for bit in valid, count and
    best_idx, boxes within 1e-2 px (the keyframe and two ticks)."""
    from frp_tpu_torch.parallel import make_mesh

    mesh = make_mesh(n_data=MESH_DATA, devices=[dev] * MESH_DATA)
    eng = RecognitionEngine(load_config(**PROFILE), mesh=mesh)
    enc = DeltaEncoder(block_bytes=128)
    batches = [tick_batch(scenes, t) for t in range(ticks + 1)]
    payloads = [enc.encode(x) for x in batches]
    timed = dev.type == "cuda"
    reset_launches()
    t0, faces = None, 0
    for t, payload in enumerate(payloads):
        if t == warm:
            if timed:
                torch.cuda.synchronize()
            t0, faces = time.perf_counter(), 0
        faces += int(eng.fetch(eng.submit_encoded(payload))["count"].sum())
    elapsed = time.perf_counter() - t0
    steady = ticks + 1 - warm
    stream = launches()
    want = {"detection_head": MESH_DATA * len(payloads), "warp_crops": MESH_DATA * len(payloads),
            "greedy_nms": 0}
    if timed and stream != want:
        raise AssertionError(f"the sharded stream launched {stream}, expected {want}")
    if not np.array_equal(eng._delta_prev.cpu().numpy(), batches[-1]):
        raise AssertionError("the sharded resident batch differs from the last tick")

    ref = RecognitionEngine(load_config(**PROFILE), device=dev)
    renc = DeltaEncoder(block_bytes=128)
    ref.fetch(ref.submit_encoded(renc.encode(batches[-1])))
    nxt = tick_batch(scenes, ticks + 1)
    syncs = {"sharded": steady_syncs(eng, [enc.encode(nxt)]),
             "unsharded": steady_syncs(ref, [renc.encode(nxt)])}

    gallery = enrol_faces([eng, ref], scenes)
    runs = [kept_anchors(lambda e=e: [e.process_frames(scenes),
                                      e.process_frames(batches[-1], fmt="yuv420")],
                         float(PROFILE["det_size"]), shards=k)
            for e, k in ((eng, MESH_DATA), (ref, 1))]
    bf16 = bf16_against_cpu(*runs)
    if not bf16["ok"]:
        raise AssertionError(f"the sharded bf16 engine against the unsharded one: {bf16}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = {**PROFILE, "compute_dtype": "float32"}
    pair = [RecognitionEngine(load_config(**f32), mesh=mesh),
            RecognitionEngine(load_config(**f32), device=dev)]
    enrol_faces(pair, batches[0], fmt="yuv420")
    errs, f32_faces = {"boxes": 0.0, "best_distance": 0.0, "fake_prob": 0.0}, 0
    for payload in payloads[:3]:
        got, want = (e.fetch(e.submit_encoded(payload)) for e in pair)
        for key in ("valid", "count", "best_idx"):
            if not np.array_equal(got[key], want[key]):
                raise AssertionError(f"the sharded f32 engine differs in {key}")
        v = want["valid"]
        f32_faces += int(v.sum())
        for key in errs:
            errs[key] = max(errs[key], float(np.abs(got[key][v] - want[key][v]).max()))
    # batches the data axis does not divide: B=1 and B=3 (shards of 1 and 0
    # rows, of 2 and 1), as RGB frames and as a raw keyframe and a delta
    uneven = {}
    for b in (1, 3):
        uenc, uref = DeltaEncoder(block_bytes=128), DeltaEncoder(block_bytes=128)
        runs = [(pair[0].process_frames(scenes[:b]), pair[1].process_frames(scenes[:b]))]
        for x in batches[:2]:
            runs.append((pair[0].fetch(pair[0].submit_encoded(uenc.encode(x[:b]))),
                         pair[1].fetch(pair[1].submit_encoded(uref.encode(x[:b])))))
        uneven[b] = 0
        for got, want in runs:
            for key in ("valid", "count", "best_idx"):
                if not np.array_equal(got[key], want[key]):
                    raise AssertionError(f"the sharded f32 engine at B={b} differs in {key}")
            v = want["valid"]
            uneven[b] += int(v.sum())
            for key in errs:
                errs[key] = max(errs[key], float(np.abs(got[key][v] - want[key][v]).max()))
        if not np.array_equal(pair[0]._delta_prev.cpu().numpy(), batches[1][:b]):
            raise AssertionError(f"the sharded resident batch at B={b} differs from its tick")
    torch.backends.cudnn.allow_tf32 = True
    if not errs["boxes"] <= 1e-2:
        raise AssertionError(f"the sharded f32 engine's boxes differ by {errs['boxes']} px")
    return dict(launches=launches(), stream_launches=stream, batches=len(payloads),
                ms_per_batch=elapsed * 1e3 / steady, frames_per_s=steady * len(scenes) / elapsed,
                faces_per_batch=faces / steady, syncs=syncs, bf16=bf16, gallery=gallery,
                f32_faces=f32_faces, f32_max_abs_err=errs, uneven_faces=uneven)


def mesh_cases() -> dict:
    """train_parity's f32 cases (batches, seeds, learning rates) as
    testing.ranks.train_case specs; MobileFaceNet's ArcFace."""
    from frp_tpu_torch.tools.pretrain_spoof import make_spoof_batch
    from frp_tpu_torch.train.synthetic import make_batch, make_identity

    crops, labels, _ = arcface_batch(PARITY_BATCH, SEED + 1)
    spoof = make_spoof_batch([make_identity(s) for s in range(32)], np.random.default_rng(SEED + 2),
                             PARITY_BATCH)
    det = make_batch(4, DET_TRAIN[0], np.random.default_rng(SEED + 3), difficulty="mix")
    adamw = dict(seed=SEED, learning_rate=PARITY_LR["adamw"], compute_dtype="float32")
    return {
        "arcface_mobilefacenet": {"kind": "arcface", "batch": (crops, labels), "kwargs": dict(
            num_classes=TRAIN_IDS, seed=SEED, learning_rate=PARITY_LR["arcface"],
            compute_dtype="float32")},
        "spoof": {"kind": "spoof", "batch": spoof, "kwargs": adamw},
        "detector": {"kind": "detector", "batch": det, "kwargs": {**adamw, "det_size": DET_TRAIN[0]}},
    }


def hold_mesh_steps(dev, got: dict, cases: dict, on: str) -> dict:
    """Each case's step over a process mesh (train_case's rank-0 result)
    against the same trainer's one-process step on dev, f32 and TF32 off,
    by hold_step's bounds; the max errors by case."""
    from frp_tpu_torch.testing.ranks import BUFFERS, make_trainer, trainer_arrays

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, case in cases.items():
        tr = make_trainer(case["kind"], None, device=dev, **case["kwargs"])
        m = tr.train_step(*case["batch"])
        want, g = trainer_arrays(tr, case["kind"]), got[name]
        keys = BUFFERS[case["kind"]]
        out[name] = hold_step(name, (g["metrics"][0], g["params"], {k: g[k] for k in keys}),
                              (m, want["params"], {k: want[k] for k in keys}),
                              on, f"one process on {dev}")
    torch.backends.cudnn.allow_tf32 = True
    return out


def run_mesh_train(dev) -> dict:
    """Phase 14 (b): MESH_RANKS gloo processes share the card as a 2 x 2
    process mesh: the ArcFace (MobileFaceNet, dp x tp), spoof and detector
    (dp) f32 steps against the one-process steps on the card, and the bf16
    ArcFace step at phase 12's batch over MESH_STEPS steps (the loss
    falling; rank 0's synchronized host ms). The ArcFace trainer's state is
    saved after its step by every rank and restored into a new trainer on
    each (train_case), and the file holds the classifier and its momentum
    whole, as gathered."""
    from frp_tpu_torch.testing.ranks import spawn_ranks, train_case

    cases = mesh_cases()
    where = f"cuda:{dev.index or 0}" if dev.type == "cuda" else "cpu"
    tmp = tempfile.mkdtemp(prefix="frp_mesh_ckpt_")
    ckpt = os.path.join(tmp, "arcface")
    spec = {"device": where, "backend": "gloo", "n_model": MESH_MODEL, "tf32": False,
            "cases": {**cases, "arcface_mobilefacenet": {**cases["arcface_mobilefacenet"],
                                                         "checkpoint": ckpt},
                      "bf16": bf16_case(MESH_STEPS)}}
    try:
        t, spawned = time.perf_counter(), time.time()
        ranks = spawn_ranks(MESH_RANKS, train_case, spec, timeout=400)
        seconds, got = time.perf_counter() - t, ranks[0]
        arc = got["arcface_mobilefacenet"]
        with np.load(ckpt + ".npz") as f:
            for key, want in (("params/classifier", arc["params"]["classifier"]),
                              ("opt/classifier/momentum_buffer", arc["momentum_buffer"]["classifier"])):
                if not np.array_equal(f[key], want):
                    raise AssertionError(f"the mesh's checkpoint holds another {key} "
                                         f"{f[key].shape} than the gathered {want.shape}")
            ckpt_shape = tuple(f["params/classifier"].shape)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got["seconds"]["entered"] = [r["seconds"]["entered"] - spawned for r in ranks]
    held = hold_mesh_steps(dev, got, cases, f"the {MESH_RANKS // MESH_MODEL} x {MESH_MODEL} gloo mesh")
    return dict(held=held, shapes=arc["shapes"], seconds=seconds, ckpt_shape=ckpt_shape,
                rank_seconds=got["seconds"], **timed_case(got["bf16"]))


def bf16_case(steps: int) -> dict:
    """(b)'s and (c)'s timed case: the bf16 ArcFace step at phase 12's
    batch and settings."""
    crops, labels, _ = arcface_batch(TRAIN_BATCH, SEED)
    return {"kind": "arcface", "batch": (crops, labels), "steps": steps,
            "kwargs": dict(num_classes=TRAIN_IDS, seed=SEED, learning_rate=TRAIN_LR)}


def timed_case(got: dict) -> dict:
    """The loss (falling, or it raises) and the median ms a step after
    TRAIN_WARM of a bf16_case result."""
    losses = [m["loss"] for m in got["metrics"]]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the mesh's bf16 ArcFace loss did not fall: {losses}")
    return dict(ms=float(np.median(got["ms"][TRAIN_WARM:])), loss=(losses[0], losses[-1]),
                steps_ms=got["ms"])


def run_nccl_rank(dev) -> dict:
    """Phase 14 (c): a one-rank NCCL group (a 1 x 1 process mesh, whose
    step takes no collective) runs the f32 ArcFace step, held against the
    one-process step on the card, and the bf16 step at phase 12's batch,
    beside the same step without a mesh in the same process."""
    from frp_tpu_torch.testing.ranks import spawn_ranks, train_case

    cases = {"arcface_mobilefacenet": mesh_cases()["arcface_mobilefacenet"]}
    t = time.perf_counter()
    got = spawn_ranks(1, train_case, {"device": f"cuda:{dev.index or 0}", "tf32": False, "cases": {
        **cases, "bf16": bf16_case(MESH_STEPS),
        "alone": {**bf16_case(MESH_STEPS), "mesh": False}}}, timeout=300)[0]
    seconds = time.perf_counter() - t
    return dict(held=hold_mesh_steps(dev, got, cases, "a one-rank NCCL group"), seconds=seconds,
                rank_seconds=got["seconds"], alone=timed_case(got["alone"]),
                **timed_case(got["bf16"]))


def run_mesh_fl(dev) -> dict:
    """Phase 14 (d): the FL service over a mesh of the card repeated
    MESH_DATA times aggregates two clients: backend mesh_psum[2], the result
    the f32 mean bit for bit (each client's f32 half on its position, one
    add) and the numpy mean within 1e-6 relative."""
    from frp_tpu_torch.parallel import make_mesh
    from frp_tpu_torch.platform.federated import FederatedService

    tmp = tempfile.mkdtemp(prefix="frp_fl_mesh_")
    try:
        svc = FederatedService(weights_dir=tmp, mesh=make_mesh(n_data=MESH_DATA,
                                                               devices=[dev] * MESH_DATA))
        rng = np.random.default_rng(SEED)
        ups = {c: {"w": rng.normal(size=(128, 64)), "b": rng.normal(size=64)}
               for c in ("site_a", "site_b")}
        for c, u in ups.items():
            svc.upload_weights(c, {k: v.tolist() for k, v in u.items()})
        res = svc.aggregate(client_ids=list(ups))
        model = svc.get_weights(res["global_model"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if res["backend"] != f"mesh_psum[{MESH_DATA}]":
        raise AssertionError(f"the FL aggregate ran on {res['backend']}")
    rel = 0.0
    for k in ("w", "b"):
        a, b = (np.asarray(ups[c][k], np.float32) for c in ups)
        if not np.array_equal(model[k], (np.float32(0.5) * a + np.float32(0.5) * b).astype(np.float64)):
            raise AssertionError(f"the mesh FL aggregate's {k} is not the f32 mean")
        mean = (ups["site_a"][k] + ups["site_b"][k]) / 2
        rel = max(rel, float(np.abs(model[k] - mean).max() / np.abs(mean).max()))
    if rel > 1e-6:
        raise AssertionError(f"the mesh FL aggregate is {rel} from the numpy mean")
    return dict(backend=res["backend"], layers=res["layer_count"], rel=rel)


# --- phase 15: the host ---------------------------------------------------------

HOST_TICKS = 16
STATIC_CAMERA, CUT_CAMERA, CUT_TICK = 3, 5, 8
BAND = 16  # SourceChangeDetector's rows a band
SWITCHES = [(False, True, 112), (True, False, 112), (True, True, 224)]  # spoof, quality, size


def render_hintless(ticks: int = HOST_TICKS) -> list[dict]:
    """Each tick's BGR frames {camera: frame} of PLATFORM_CAMERAS synthetic
    1080p sources (phase 10's motion, camera c from seed c), rendered before
    any timing: camera STATIC_CAMERA repeats its first frame, and camera
    CUT_CAMERA cuts to another scene (seed 100 + CUT_CAMERA) at CUT_TICK."""
    srcs = {c: SyntheticSource(*PLATFORM_SOURCE, seed=c) for c in range(PLATFORM_CAMERAS)}
    cut = SyntheticSource(*PLATFORM_SOURCE, seed=100 + CUT_CAMERA)
    out: list[dict] = []
    for t in range(ticks):
        frames = {}
        for c, src in srcs.items():
            if c == STATIC_CAMERA and t:
                frames[c] = out[0][c]
            elif c == CUT_CAMERA and t >= CUT_TICK:
                frames[c] = cut.read()[1]
            else:
                frames[c] = src.read()[1]
        out.append(frames)
    return out


def band_diff(cur: np.ndarray, prev: np.ndarray, band: int = BAND) -> list:
    """numpy: the merged half-open (y0, y1) row bands of `band` rows in
    which two frames differ (what the native dirty_bands reports)."""
    h = cur.shape[0]
    rows = np.zeros(-(-h // band) * band, bool)
    rows[:h] = (cur != prev).reshape(h, -1).any(axis=1)
    out: list = []
    for i in np.flatnonzero(rows.reshape(-1, band).any(axis=1)):
        y0, y1 = int(i) * band, min(h, (int(i) + 1) * band)
        if out and out[-1][1] == y0:
            out[-1] = (out[-1][0], y1)
        else:
            out.append((y0, y1))
    return out


def host_ms(fn, reps: int) -> float:
    """Median host-clock ms of `reps` calls of fn()."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def run_framepack(ticks: list) -> dict:
    """Phase 15 (a): the port's host library, built by g++ from
    csrc/framepack.cpp, against its numpy versions on the card's host, bit
    for bit, over ticks 0 and 1 of the hintless cameras: the letterbox
    packer, the delta block search (count and fill) and the band detector
    (bands, and the previous frame after its update)."""
    from frp_tpu_torch.utils import native

    if native.get_framepack() is None:
        raise AssertionError("the framepack library did not build from csrc/framepack.cpp")
    path = native.library_path()
    if path != cuda_build.host_library_path("framepack") or not os.path.exists(path):
        raise AssertionError(f"framepack loaded from {path}")
    size = PROFILE["det_size"]
    prev_frames, frames = list(ticks[0].values()), list(ticks[1].values())
    rows = batching.active_rows_for([f.shape[:2] for f in frames], size)
    got = native.letterbox_i420_batch(frames, size, rows=rows)
    for k, f in enumerate(frames):
        img, sc, off = batching.letterbox_i420(f, size, rows)
        if not (np.array_equal(got[0][k], img) and got[1][k] == np.float32(sc)
                and tuple(got[2][k]) == tuple(off)):
            raise AssertionError(f"letterbox_i420_batch differs from letterbox_i420 on frame {k}")
    ms = {"letterbox": (host_ms(lambda: native.letterbox_i420_batch(frames, size, rows=rows), 5),
                        host_ms(lambda: [batching.letterbox_i420(f, size, rows) for f in frames], 2))}

    block = int(os.getenv("FRP_DELTA_BLOCK", "128"))  # the scan's block size
    cur, prev = (batching.build_batch_i420(dict(enumerate(fs)), size, active_rows=rows)[0]
                 .reshape(len(fs), -1) for fs in (frames, prev_frames))
    nblocks = cur.shape[1] // block
    count = native.delta_blocks(cur, prev, block, 0)
    cap = next(nblocks // d for d in DeltaEncoder.LADDER if count <= nblocks // d)
    out = {}
    for name, search in (("native", native.delta_blocks), ("numpy", batching.changed_blocks)):
        idx = np.full((len(frames), cap), -1, np.int32)
        blocks = np.zeros((len(frames), cap, block), np.uint8)
        out[name] = (search(cur, prev, block, 0), search(cur, prev, block, cap, idx, blocks),
                     idx, blocks)
    (c0, c1, idx, blocks), (n0, n1, want_idx, want_blocks) = out["native"], out["numpy"]
    if not (count == c0 == c1 == n0 == n1 and np.array_equal(idx, want_idx)
            and np.array_equal(blocks, want_blocks)):
        raise AssertionError(f"delta_blocks differs from the numpy search (counts {c0}, {c1}, "
                             f"numpy {n0}, {n1})")
    ms["delta_blocks"] = (
        host_ms(lambda: native.delta_blocks(cur, prev, block, cap, idx, blocks), 5),
        host_ms(lambda: batching.changed_blocks(cur, prev, block, cap, want_idx, want_blocks), 2))

    bands = []
    for f, p in zip(frames, prev_frames):
        copy = p.copy()
        got_bands = native.dirty_bands(f, copy, BAND)
        if got_bands != band_diff(f, p) or not np.array_equal(copy, f):
            raise AssertionError(f"dirty_bands {got_bands} against the numpy diff {band_diff(f, p)}")
        bands.append(sum(y1 - y0 for y0, y1 in got_bands))
    copies = [[p.copy() for p in prev_frames] for _ in range(5)]
    native_ms = []
    for cp in copies:  # a fresh previous frame a pass: the update writes into it
        t = time.perf_counter()
        for f, p in zip(frames, cp):
            native.dirty_bands(f, p, BAND)
        native_ms.append((time.perf_counter() - t) * 1e3)
    ms["dirty_bands"] = (float(np.median(native_ms)),
                         host_ms(lambda: [band_diff(f, p) for f, p in zip(frames, prev_frames)], 2))
    return dict(path=path, frames=len(frames), rows=rows, block=block, count=count, cap=cap,
                dirty_rows=bands, ms=ms)


def run_mixed_hints(size: int, scans: int = 12) -> dict:
    """Phase 15 (b), last part: a synthetic 1080p camera whose scan takes
    read_with_hints while a probe reads it before scans 1, 2, 7 and 8 (its
    hints are then None and the change detector steps in), every other scan
    taking the source's own hints. Each scan's cached batch must equal a
    full letterbox of the frame it read: a detector whose previous copy
    lagged the slot would leave the face's old pixels in it."""
    from frp_tpu_torch.platform.state import Camera

    cam = Camera(0, "probe", source="synthetic:%dx%d" % PLATFORM_SOURCE)
    state, kinds = {}, []
    for k in range(scans):
        if k in (1, 2, 7, 8):
            cam.read()  # a health probe or snapshot between two scans
        ok, frame, hints = cam.read_with_hints()
        rows = batching.active_rows_for([frame.shape[:2]], size)
        got, _ = batching.build_batch_i420_cached({0: frame}, size, state, hints={0: hints},
                                                   active_rows=rows)
        want, _ = batching.build_batch_i420({0: frame}, size, active_rows=rows)
        if not np.array_equal(got, want):
            raise AssertionError(f"mixed hints: scan {k}'s cached batch differs from a full letterbox")
        kinds.append("source" if hints is not None else
                     "detector" if 0 in state.get("detectors", {}) else "full")
    if kinds[3:7] != ["source"] * 4 or "detector" not in kinds[7:9]:
        raise AssertionError(f"mixed hints: the scans took {kinds}")
    return dict(scans=scans, kinds=kinds)


def run_hintless(dev, ticks: list, **overrides) -> dict:
    """Phase 15 (b): the scan as a user runs it over cameras without change
    hints. AppContext from the default config (`overrides` only for a
    rehearsal on the CPU) with 8 PushSource cameras; the ticks' frames are
    pushed, then one run_scan each. Every scan's batch, rebuilt on the host
    from the payloads sent (DeltaEncoder.apply_host), must equal
    build_batch_i420 of its frames; faces are found and camera 0's enrolled
    face matches every scan; kernels 1 and 2 once a scan; from the second
    timed scan on, the static camera's delta hint is [] and every other
    slot's a list of block ranges (the change detector's bands)."""
    from frp_tpu_torch.api.routes import camera as camera_routes

    tmp = tempfile.mkdtemp(prefix="frp_hintless_")
    router, sio, ctx, seen = platform_app(dev, os.path.join(tmp, "data"), source="push", **overrides)
    cfg = ctx.cfg
    size = cfg.det_size
    rows = batching.active_rows_for([f.shape[:2] for f in ticks[0].values()], size)
    timed = dev.type == "cuda"
    sent, slot_hints, build_ms = [], [], []
    submit, delta_hints_for = ctx.engine.submit_encoded, camera_routes.delta_hints_for
    build_cached = camera_routes.build_batch_i420_cached

    def recording_submit(enc, *args, **kwargs):
        sent.append((enc[0], *(np.array(a, copy=True) for a in enc[1:])))
        return submit(enc, *args, **kwargs)

    def recording_hints(state, block):
        hints = delta_hints_for(state, block)
        slot_hints.append(hints)
        return hints

    def timed_build(*args, **kwargs):
        t = time.perf_counter()
        out = build_cached(*args, **kwargs)
        build_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def push(frames):
        for c, f in frames.items():
            ctx.cameras.get(c).source.push(f)

    ctx.engine.submit_encoded = recording_submit
    camera_routes.delta_hints_for = recording_hints
    camera_routes.build_batch_i420_cached = timed_build
    try:
        push(ticks[0])
        ctx.run_scan(cfg.face_tolerance, cfg.frame_skip, 10, True)
        enrol(ctx, ticks[0][0])
        seen["out"].clear()
        reset_launches()
        scans = []
        for t, frames in enumerate(ticks):
            if t == 1:  # tick 0 is the change detector's first sight: full letterboxes
                ctx.timers.reset()
                seen["payload_bytes"].clear()
                if timed:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
            push(frames)
            scans.append(ctx.run_scan(cfg.face_tolerance, 1, cfg.max_faces_per_frame))
        seconds = time.perf_counter() - t0
        got = launches()
        resident = ctx.engine._delta_prev.cpu().numpy()
    finally:
        camera_routes.delta_hints_for = delta_hints_for
        camera_routes.build_batch_i420_cached = build_cached
        ctx.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)

    if len(sent) != len(ticks) + 1 or len(slot_hints) != len(ticks) + 1:
        raise AssertionError(f"{len(sent)} payloads and {len(slot_hints)} hints for "
                             f"{len(ticks) + 1} scans")
    host = None
    full_ms = []
    for k, (payload, frames) in enumerate(zip(sent, [ticks[0], *ticks])):
        host = (payload[1].reshape(len(frames), -1).copy() if payload[0] == "raw"
                else DeltaEncoder.apply_host(host, payload[1], payload[2]))
        t = time.perf_counter()
        want, _ = batching.build_batch_i420(frames, size, active_rows=rows)
        full_ms.append((time.perf_counter() - t) * 1e3)
        if not np.array_equal(host, want.reshape(len(frames), -1)):
            raise AssertionError(f"scan {k}: the batch rebuilt from the payloads differs from "
                                 "build_batch_i420 of its frames")
    if not np.array_equal(resident.reshape(host.shape), host):
        raise AssertionError("the engine's resident batch differs from the payloads' rebuild")
    tol = cfg.face_tolerance
    camera0 = []
    for k, (scan, out) in enumerate(zip(scans, seen["out"])):
        hits = [d["distance"] for d in scan["detections"]
                if d["target"] == ENROLLED and d["camera_id"] == 0 and d["distance"] <= tol]
        if int(out["count"].sum()) == 0 or not hits:
            raise AssertionError(f"hintless scan {k}: {int(out['count'].sum())} faces, camera 0 "
                                 f"hits {hits}")
        camera0.append(min(hits))
    delta = dict(ctx.engine.delta_stats)
    if delta["deltas"] == 0 or delta["desyncs"] != 0:
        raise AssertionError(f"delta_stats {delta}")
    want_launches = {"detection_head": len(ticks), "warp_crops": len(ticks), "greedy_nms": 0}
    if timed and got != want_launches:
        raise AssertionError(f"hintless launches {got}, expected {want_launches}")
    # slot_hints[0] is the dry scan's, [1] tick 0's (the detectors' first sight)
    if any(h is not None for h in slot_hints[1]):
        raise AssertionError(f"tick 0's delta hints {slot_hints[1]}: expected full letterboxes")
    for t, hints in enumerate(slot_hints[2:], start=1):
        for c, h in enumerate(hints):
            if c == STATIC_CAMERA:
                if h != []:
                    raise AssertionError(f"tick {t}: the static camera's delta hint is {h}")
            elif not (isinstance(h, list) and h and all(len(r) == 2 for r in h)):
                raise AssertionError(f"tick {t}: camera {c}'s delta hint is {h}")
    stages = ctx.timers.summary()
    steady = len(ticks) - 1
    return dict(
        launches=got, scans=len(ticks), delta=delta, camera0_distance=(min(camera0), max(camera0)),
        faces_per_scan=float(np.mean([int(o["count"].sum()) for o in seen["out"]])),
        letterbox_ms=stages["scan.letterbox"]["mean_ms"],
        parts_ms={k.split(".", 1)[1]: v["mean_ms"] for k, v in stages.items() if k.startswith("scan.")},
        cached_ms=(float(np.median(build_ms[2:])), float(np.mean(build_ms[2:]))),
        full_ms=(float(np.median(full_ms[2:])), float(np.mean(full_ms[2:]))),
        payload_kb=float(np.median(seen["payload_bytes"])) / 1024,
        payload_kb_max=max(seen["payload_bytes"]) / 1024, scans_per_s=steady / seconds,
        cut_blocks=sum(b1 - b0 for b0, b1 in slot_hints[CUT_TICK + 1][CUT_CAMERA]),
        mixed=run_mixed_hints(size),
    )


def run_switches(dev, scenes: np.ndarray, **overrides) -> dict:
    """Phase 15 (c): build_pipeline with each of SWITCHES (spoof, quality,
    spoof size) and RecognitionEngine(with_spoof=False), at f32 (TF32 off)
    on `dev` and on the CPU over phase 6's frames, held to phase 6's
    tolerances (valid, count and best_idx bit for bit, boxes within
    1e-2 px); the outputs switched off are absent (the packed fake_prob
    column zeros, encode_image's fake_prob None)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(**{**PROFILE, "compute_dtype": "float32", **overrides})
    engs = [RecognitionEngine(cfg, device=d, with_spoof=False) for d in (dev, "cpu")]
    ref = engs[1].process_frames(scenes)
    if not ref["valid"].any():
        raise AssertionError("the CPU engine found no face in the switch frames")
    embs = ref["embeddings"][ref["valid"]]
    embs = embs * np.linspace(1.0, 0.8, len(embs), dtype=np.float32)[:, None]
    for eng in engs:
        for n, e in enumerate(embs):
            eng.gallery.add(f"id{n}", e)
    timed = dev.type == "cuda"
    reset_launches()
    held: dict = {}

    def hold(name, got, want, absent):
        for key in ("valid", "count", "best_idx"):
            if not np.array_equal(got[key], want[key]):
                raise AssertionError(f"{name}: cuda and cpu differ in {key}")
        for out in (got, want):
            if absent & set(out):
                raise AssertionError(f"{name}: {sorted(absent & set(out))} present")
        v = want["valid"]
        errs = {key: float(np.abs(got[key][v] - want[key][v]).max())
                for key in ("boxes", "best_distance", "fake_prob", "quality") if key in want}
        if not errs["boxes"] <= 1e-2:
            raise AssertionError(f"{name}: cuda and cpu boxes differ by {errs['boxes']} px")
        held[name] = dict(faces=int(v.sum()), max_abs_err=errs)

    for spoof, quality, spoof_size in SWITCHES:
        outs = []
        for eng in engs:
            pipe = build_pipeline(
                device=eng.device, det_size=cfg.det_size, max_faces=cfg.max_faces_per_frame,
                pre_nms_topk=cfg.pre_nms_topk, conf_thresh=cfg.det_conf_threshold,
                nms_thresh=cfg.det_nms_threshold, iom_thresh=cfg.det_nms_iom_threshold,
                tolerance=cfg.face_tolerance, with_spoof=spoof, with_quality=quality,
                compute_dtype=cfg.compute_dtype, spoof_size=spoof_size,
                distance_scale=eng.distance_scale)
            gal, gal_valid, _ = eng.gallery.device_view()
            out = pipe(eng.params, torch.from_numpy(scenes).to(eng.device), gal, gal_valid, eng._priors)
            outs.append({k: v.cpu().numpy() for k, v in out.items()})
        absent = (set() if spoof else {"fake_prob"}) | (set() if quality else {"quality", "blur_score"})
        hold(f"build_pipeline spoof={spoof} quality={quality} spoof_size={spoof_size}", *outs, absent)
    res = [eng.fetch(eng.submit_encoded(DeltaEncoder(block_bytes=128).encode(tick_batch(scenes, 0))))
           for eng in engs]
    if any(np.any(r["fake_prob"] != 0) for r in res):
        raise AssertionError("with_spoof=False: the packed fake_prob column is not zeros")
    hold("RecognitionEngine with_spoof=False", *res, set())
    faces = [eng.encode_image(scenes[int(np.flatnonzero(ref["valid"].any(axis=1))[0])]) for eng in engs]
    if not faces[0] or len(faces[0]) != len(faces[1]) or any(f["fake_prob"] is not None
                                                             for fs in faces for f in fs):
        raise AssertionError(f"with_spoof=False encode_image: {len(faces[0])} and {len(faces[1])} "
                             "faces, fake_prob must be None")
    got = launches()
    n = len(SWITCHES)
    want = {"detection_head": 2, "warp_crops": n + 2, "greedy_nms": n}
    if timed and got != want:
        raise AssertionError(f"switch launches {got}, expected {want}")
    return dict(launches=got, held=held)


def run_stage_flops(engines: dict) -> dict:
    """Phase 15 (d): engine_stage_flops for each (engine, occupancy, busy
    ms, ms/batch) of `engines`, at FRAMES frames a batch, and the MFU over
    the device-busy time and over the ms a batch."""
    out = {}
    for name, (eng, occupancy, busy, ms) in engines.items():
        fl = engine_stage_flops(eng, FRAMES, occupancy=occupancy)
        out[name] = dict(flops=fl, occupancy=occupancy, busy_ms=busy, ms_per_batch=ms,
                         mfu_busy=None if busy is None else mfu(fl["total"], busy / 1e3),
                         mfu_wall=mfu(fl["total"], ms / 1e3))
    return out


# --- phase 16: the entry ---------------------------------------------------------

ENTRY_CALLS = 20


def run_entry(dev) -> dict:
    """Phase 16: the twin of __graft_entry__.entry() (testing/entry.py).
    fn(*example_args) once, the kernels' inputs recorded as they pass: the
    warp and the greedy kernel at K=128 once each, never the fused head; the
    14 results at the reference's shapes, finite on valid slots, faces
    found. Then ENTRY_CALLS more calls, ms a call on the synchronized host
    clock. The same forward at f32 (TF32 off) on `dev` and on the CPU: valid
    and count bit for bit, boxes within 1e-2 px. Last, both kernels on the
    recorded inputs against their plain versions, timed as phase 3 times
    them."""
    from frp_tpu_torch.testing.entry import entry

    timed = dev.type == "cuda"
    sync = torch.cuda.synchronize if timed else (lambda: None)
    fn, args = entry(device=dev)
    wrapped = {"warp_crops": (align_cuda, "warp_crops_kernel"),
               "greedy_nms": (nms_cuda, "greedy_suppress_kernel")}
    real = {name: getattr(mod, attr) for name, (mod, attr) in wrapped.items()}
    seen: dict = {}

    def recording(name):
        def call(*a):
            seen.setdefault(name, a)
            return real[name](*a)
        return call

    for name, (mod, attr) in wrapped.items():
        setattr(mod, attr, recording(name))
    reset_launches()
    try:
        with torch.no_grad():
            out = fn(*args)
        sync()
    finally:
        for name, (mod, attr) in wrapped.items():
            setattr(mod, attr, real[name])
    once = launches()
    if timed and once != {"detection_head": 0, "warp_crops": 1, "greedy_nms": 1}:
        raise AssertionError(f"one entry call launched {once}")
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    if len(out) != 14 or shapes["embeddings"] != (2, 8, 128) or shapes["topk_idx"] != (2, 8, 5):
        raise AssertionError(f"the entry's results {shapes}")
    valid = out["valid"]
    for key, v in out.items():
        if v.is_floating_point() and not bool(torch.isfinite(v[valid]).all()):
            raise AssertionError(f"the entry's {key} is not finite on its valid slots")
    count = out["count"].cpu().tolist()
    if min(count) == 0:
        raise AssertionError(f"the entry found no face in a frame: count {count}")
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        for _ in range(ENTRY_CALLS):
            fn(*args)
        sync()
    ms = (time.perf_counter() - t0) * 1e3 / ENTRY_CALLS
    got_launches = launches()

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    (f32, a32), (cpu, acpu) = entry(dev, "float32"), entry("cpu", "float32")
    with torch.no_grad():
        got, want = f32(*a32), cpu(*acpu)
    torch.backends.cudnn.allow_tf32 = True
    for key in ("valid", "count"):
        if not torch.equal(got[key].cpu(), want[key]):
            raise AssertionError(f"the entry at f32 differs from the CPU in {key}")
    errs = {key: max_err(got[key].cpu()[want["valid"]], want[key][want["valid"]])
            for key in ("boxes", "embeddings", "fake_prob")}
    if not errs["boxes"] <= 1e-2:
        raise AssertionError(f"the entry's f32 boxes differ from the CPU's by {errs['boxes']} px")
    kernels = {}
    if timed:
        kernels = {"warp_crops": hold_warp(*seen["warp_crops"]),
                   "greedy_nms": hold_greedy(*seen["greedy_nms"][:2], "entry")}
    return dict(launches=got_launches, once=once, count=count, ms=ms, f32_max_abs_err=errs,
                f32_faces=int(want["valid"].sum()), kernels=kernels)


# --- phase 17: the bench ---------------------------------------------------------

BENCH_TICKS = 2  # phase 17's attempt: one window of 2-tick submissions
BENCH_TIMEOUT = 300  # s; the attempt takes 35-62 s on an H100 80GB HBM3 at 700 W


def bench_batch() -> tuple[np.ndarray, str]:
    """The bench's batch with the walking face present, the batch it counts
    its faces on: [16, 552, 640] I420 at BENCH_TICKS=2, built as the bench
    builds it, from its seed."""
    from frp_tpu_torch import bench

    rng = np.random.default_rng(0)
    bench.gallery_entries(rng, 128)  # the draws before the scene's
    prod = bench.Producer(bench.Scene(rng), PROFILE["det_size"], BENCH_TICKS, 128)
    prod.first()
    batch, fmt, _ = prod.next_ticks()
    return batch.copy(), fmt


def bench_f32_faces(dev) -> int:
    """The faces the port's f32 engine (TF32 off) finds in the bench's batch
    with the walking face present."""
    batch, fmt = bench_batch()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = load_config(**{**PROFILE, "compute_dtype": "float32"}, frames_per_batch=len(batch))
        eng = RecognitionEngine(cfg, device=dev)
        return int(eng.fetch(eng.submit(batch, fmt=fmt))["count"].sum())
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True


def hold_bench_kernels(dev) -> dict:
    """Kernels 1 and 2 at the bench's shapes: the bench's batch with the
    walker through the default bf16 engine in this process, at the bench's
    16 frames a batch, the kernels' inputs recorded as they pass (each
    launched once); then both kernels on those inputs against their plain
    versions, timed as phase 3 times them. These launches are a check's and
    join no count."""
    batch, fmt = bench_batch()
    eng = RecognitionEngine(load_config(**PROFILE, frames_per_batch=len(batch)), device=dev)
    wrapped = {"detection_head": (detection_cuda, "fused_head_kernel"),
               "warp_crops": (align_cuda, "warp_crops_kernel")}
    real = {name: getattr(mod, attr) for name, (mod, attr) in wrapped.items()}
    seen: dict = {}

    def recording(name):
        def call(*a):
            seen.setdefault(name, a)
            return real[name](*a)
        return call

    for name, (mod, attr) in wrapped.items():
        setattr(mod, attr, recording(name))
    reset_launches()
    try:
        faces = int(eng.fetch(eng.submit(batch, fmt=fmt))["count"].sum())
        torch.cuda.synchronize()
    finally:
        for name, (mod, attr) in wrapped.items():
            setattr(mod, attr, real[name])
    once = launches()
    if once != {"detection_head": 1, "warp_crops": 1, "greedy_nms": 0}:
        raise AssertionError(f"one bench batch launched {once}")
    return dict(faces=faces, kernels={"detection_head": hold_head(*seen["detection_head"]),
                                      "warp_crops": hold_warp(*seen["warp_crops"])})


def run_bench(dev) -> dict:
    """Phase 17: one attempt of the port's bench, ``python -m
    frp_tpu_torch.bench --once`` as a child with BENCH_WINDOWS=1 and
    BENCH_TICKS=2 (the other knobs at their defaults), under a timeout. Holds
    its JSON line: every face of the 16 frames found (12 a frame; where the
    card finds fewer, as many as the port's f32 engine finds in the same
    batch), the window's resident batch equal to the producer's last batch
    bit for bit (the bench checks it against its replay of the window's
    payloads with DeltaEncoder.apply_host and raises otherwise), and kernels
    1 and 2 launched once a batch in the child (at least the timed and
    latency batches), kernel 3 never. The child's counts start at 0 with
    its process and are read at its end. This process's cached device memory
    is released first; its context stays, so the child shares the card and
    its times are a smoke check's, not the standalone bench's."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    env = dict(os.environ, BENCH_WINDOWS="1", BENCH_TICKS=str(BENCH_TICKS))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "frp_tpu_torch.bench", "--once"],
                         cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                         capture_output=True, text=True, timeout=BENCH_TIMEOUT)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"the bench attempt exited {res.returncode}: {res.stderr[-2000:]}")
    line = next((ln for ln in reversed(res.stdout.splitlines()) if ln.startswith("{")), None)
    if line is None:
        raise AssertionError(f"the bench attempt printed no JSON: {res.stdout[-1000:]}")
    out = json.loads(line)
    d = out["detail"]
    frames = FRAMES * BENCH_TICKS
    want = 12 * frames
    f32 = None
    if d["faces_per_batch"] != want:
        f32 = bench_f32_faces(dev)
        if d["faces_per_batch"] != f32:
            raise AssertionError(f"the bench found {d['faces_per_batch']} faces in {frames} "
                                 f"frames, the f32 engine {f32} ({want} rendered)")
    check = d["resident_check"]
    if not (d["delta_transfer"] and check and check["windows"] == d["windows_completed"] == 1):
        raise AssertionError(f"the window's resident batch was not held: {check}")
    got = d["kernel_launches"]
    if not (got["detection_head"] == got["warp_crops"]
            >= d["batches"] + len(d["detection_to_alert_ms"]) and got["greedy_nms"] == 0):
        raise AssertionError(f"the bench's launches {got} over {d['batches']} timed batches")
    return dict(out=out, detail=d, launches=got, seconds=seconds, f32_faces=f32, want=want)


# --- phase 18: the accuracy diagnostics -------------------------------------------

# the smoke size of both tools (their defaults: 20 identities x 4 variants)
DIAG_SIZE = ["--arch", "iresnet18", "--identities", "3", "--variants", "2"]
DIAG_TOOLS = {"diagnose_e2e_gap": ["--tier", "2"], "prototype_flip_tta": []}
# tests/test_torch_diagnostics.py's tolerances: the landmark error in det-640
# px; AUC, EER and medians; a TPR or FPR may differ only where a pair
# distance lies this close to its threshold
DIAG_LM_TOL = 0.05
DIAG_TOL = 1e-4
DIAG_THRESHOLDS = (0.4, 0.6)


def diag_batches(name: str, size: list) -> int:
    """The engine batches (8 scenes a batch) one run of tool `name` submits:
    the diagnosis once over its scenes, the prototype twice a tier."""
    scenes = int(size[size.index("--identities") + 1]) * int(size[size.index("--variants") + 1])
    return -(-scenes // 8) * (1 if name == "diagnose_e2e_gap" else 8)


def diag_metric_sets(name: str, report: dict) -> list:
    """A report's threshold_metrics dicts in the order the tool computes them."""
    if name == "diagnose_e2e_gap":
        return [report[k] for k in ("path_a_engine_e2e", "path_c_gt_landmarks_det640",
                                    "path_b_gt_landmarks_native")]
    return [report["tiers"][t][leg] for t in ("0", "1", "2", "3") for leg in ("baseline", "flip_avg")]


def diag_run(name: str, dev, dtype: str, out_dir: str, size: list = DIAG_SIZE) -> dict:
    """One in-process run of tool `name`'s main(argv) on `dev` at
    COMPUTE_DTYPE=`dtype` (f32 with TF32 off): its report, wall s, the
    kernels' launches from a count of 0, and the pair distances of each
    pair_distances call. The tool's own printout is kept out of the log."""
    from frp_tpu_torch.train import pairs

    module = importlib.import_module(f"frp_tpu_torch.tools.{name}")
    real = pairs.pair_distances
    dists = []

    def recording(embeddings, labels):
        same, diff = real(embeddings, labels)
        dists.append(np.concatenate([same, diff]))
        return same, diff

    old = os.environ.get("COMPUTE_DTYPE")
    os.environ["COMPUTE_DTYPE"] = dtype
    torch.backends.cudnn.allow_tf32 = dtype != "float32"
    torch.backends.cuda.matmul.allow_tf32 = False
    pairs.pair_distances = recording
    argv = size + DIAG_TOOLS[name] + ["--device", dev.type,
                                      "--out", os.path.join(out_dir, f"{name}_{dev.type}_{dtype}.json")]
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            report = module.main(argv)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    finally:
        pairs.pair_distances = real
        if old is None:
            del os.environ["COMPUTE_DTYPE"]
        else:
            os.environ["COMPUTE_DTYPE"] = old
        torch.backends.cudnn.allow_tf32 = True  # torch's defaults
    seconds = time.perf_counter() - t0
    got = launches()
    want = diag_batches(name, size)
    if dev.type == "cuda" and got != {"detection_head": want, "warp_crops": want, "greedy_nms": 0}:
        raise AssertionError(f"{name} at {dtype} launched {got}, expected kernels 1 and 2 "
                             f"{want} times each and kernel 3 never")
    sets = diag_metric_sets(name, report)
    if len(dists) != len(sets) or not all(m["n_same"] > 0 and m["n_diff"] > 0 for m in sets):
        raise AssertionError(f"{name} at {dtype} on {dev.type}: pair sets {[len(d) for d in dists]}")
    return dict(report=report, seconds=seconds, launches=got, dists=dists,
                chains=chain_launches(dev))


def hold_diag(name: str, got: dict, want: dict) -> dict:
    """The f32 card run against the CPU run of the same tool: every integer
    field equal (scenes, detected, common, n_same, n_diff, ...), the
    landmark error within DIAG_LM_TOL, TPR and FPR equal unless a pair
    distance of that set lies within DIAG_TOL of the threshold in either
    run, the other floats within DIAG_TOL. Returns the largest float error
    and the rates left unheld by a near-threshold distance."""
    errs = {"landmark_px": 0.0, "metrics": 0.0}
    near = []

    def walk(g, w, path):
        if isinstance(w, dict):
            if g.keys() != w.keys():
                raise AssertionError(f"{name}: fields differ at {path}")
            for k in w:
                if k != "backend":
                    walk(g[k], w[k], f"{path}/{k}")
        elif isinstance(w, float) and "landmark_err" in path:
            errs["landmark_px"] = max(errs["landmark_px"], abs(g - w))
            if abs(g - w) > DIAG_LM_TOL:
                raise AssertionError(f"{name}: {path} {g} on the card, {w} on the cpu")
        elif isinstance(w, float) and "@" not in path:
            errs["metrics"] = max(errs["metrics"], abs(g - w))
            if abs(g - w) > DIAG_TOL:
                raise AssertionError(f"{name}: {path} {g} on the card, {w} on the cpu")
        elif not isinstance(w, float) and g != w:
            raise AssertionError(f"{name}: {path} {g} on the card, {w} on the cpu")

    walk(got["report"], want["report"], "")
    for i, (g, w) in enumerate(zip(diag_metric_sets(name, got["report"]),
                                   diag_metric_sets(name, want["report"]))):
        both = np.concatenate([got["dists"][i], want["dists"][i]])
        for t in DIAG_THRESHOLDS:
            for k in (f"tpr@{t}", f"fpr@{t}"):
                if np.abs(both - t).min() <= DIAG_TOL:
                    near.append((i, k, g[k], w[k]))
                elif g[k] != w[k]:
                    raise AssertionError(f"{name}: set {i} {k} {g[k]} on the card, {w[k]} on the cpu")
    return dict(max_abs_err=errs, near=near)


def diag_summary(name: str, report: dict) -> str:
    """One line of a report: counts, the landmark error, each path's or
    tier's TPR@0.6 / FPR@0.6 / AUC."""
    def m(x):
        return f"TPR@0.6 {x['tpr@0.6']:.4f}, FPR@0.6 {x['fpr@0.6']:.4f}, AUC {x['auc']:.4f}"
    if name == "diagnose_e2e_gap":
        lm = report["landmark_err_det640_px"]
        return (f"detected {report['detected']} of {report['scenes']}; landmark err det-640 px mean "
                f"{lm['mean']}, median {lm['median']}, p90 {lm['p90']}; A {m(report['path_a_engine_e2e'])}; "
                f"C {m(report['path_c_gt_landmarks_det640'])}; B {m(report['path_b_gt_landmarks_native'])}")
    return "; ".join(f"tier {t} common {r['common']} of {r['scenes']} (base {r['detected_base']}, "
                     f"flipped {r['detected_flipped']}): baseline {m(r['baseline'])} -> flip-avg "
                     f"{m(r['flip_avg'])}" for t, r in report["tiers"].items())


def run_diagnostics(dev, size: list = DIAG_SIZE) -> dict:
    """Phase 18: each accuracy diagnostic's main(argv) in process on `dev`
    at f32 (TF32 off) and at the default bf16, then on the CPU at f32; the
    f32 runs held by hold_diag. Launches are the card runs' sum."""
    runs, held = {}, {}
    with tempfile.TemporaryDirectory() as out_dir:
        for name in DIAG_TOOLS:
            for dtype in ("float32", "bfloat16"):
                runs[(name, dtype)] = diag_run(name, dev, dtype, out_dir, size)
            runs[(name, "cpu")] = diag_run(name, torch.device("cpu"), "float32", out_dir, size)
            held[name] = hold_diag(name, runs[(name, "float32")], runs[(name, "cpu")])
    total = {k: sum(r["launches"][k] for (n, d), r in runs.items() if d != "cpu")
             for k in launches()}
    return dict(runs=runs, held=held, launches=total, size=size)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "an NVIDIA card", file=sys.stderr)
        return 1
    t_run = time.perf_counter()
    dev = torch.device("cuda")
    count_forwards()
    device_kind = torch.cuda.get_device_name(0)
    smi = gpu_name_and_limit()
    say("device", f"{device_kind} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"devices {torch.cuda.device_count()}")
    print(smi, flush=True)

    t0 = time.perf_counter()
    built = cuda_build.build()
    say("build", f"nvcc sm_90a into {cuda_build.BUILD_DIR}, one process a kernel: "
        + (", ".join(f"{k} {v:.1f} s" for k, v in built.items()) or "all already built")
        + f"; {time.perf_counter() - t0:.1f} s in all")

    scenes = render_scenes(FRAMES, PROFILE["det_size"], SEED)
    frames = torch.from_numpy(scenes).to(dev)
    checks = {
        "detection_head": check_detection_head(dev),
        "warp_crops": check_warp_crops(dev, frames),
        "greedy_nms": check_greedy_nms(dev, 512),
    }
    crowd = check_detection_head(dev, crowd=True)
    greedy = {
        "ms_k256": check_greedy_nms(dev, 256),
        "ms_k1024": check_greedy_nms(dev, 1024),
        "ms_all_above": check_greedy_nms(dev, 512, "crowd"),
        "ms_sparse": check_greedy_nms(dev, 512, "sparse"),
    }
    for name, c in [*checks.items(), ("detection_head", crowd),
                    *(("greedy_nms", c) for c in greedy.values())]:
        say("kernels", f"{name} {c['shape']}: equal to plain (max abs err {c['max_abs_err']:.3g}); "
            f"kernel {c['ms'] * 1e3:.1f} us, bound {c['bound_ms'] * 1e3:.3f} us by {c['bound_by']}, "
            f"plain {c['plain_ms'] * 1e3:.1f} us"
            + (f", grid_sample {c['library_ms'] * 1e3:.1f} us (max abs diff "
               f"{c['library_max_abs_err']:.3g})" if c["library_ms"] is not None else "")
            + (f"; faces far larger than the frame: max abs err "
               f"{c['large_face_max_abs_err']:.3g}" if "large_face_max_abs_err" in c else ""))
    say("kernels", "all three kernels equal their plain versions")
    chains = check_bn_act(dev)
    for key, c in chains.items():
        say("kernels", f"bn_act {key} {c['shape']} bf16: within {c['max_ulps']} ulp of the f32 "
            f"chain rounded once (max abs err {c['max_abs_err']:.3g}); kernel {c['ms'] * 1e3:.1f} us, "
            f"bound {c['bound_ms'] * 1e3:.1f} us by {c['bound_by']} "
            f"({100 * c['bound_ms'] / c['ms']:.1f} % of it), plain (the f32 chain) "
            f"{c['plain_ms'] * 1e3:.1f} us, the eager bf16 chain it replaced {c['library_ms'] * 1e3:.1f} "
            f"us (max abs diff {c['library_max_abs_err']:.3g})")
    passes = check_add_ln(dev)
    for key, c in passes.items():
        say("kernels", f"add_ln {key} {c['shape']} bf16: r exact, LN(r) within {c['max_ulps']} ulp "
            f"of its f32 arithmetic rounded once (max abs err {c['max_abs_err']:.3g}); kernel "
            f"{c['ms'] * 1e3:.1f} us, bound {c['bound_ms'] * 1e3:.1f} us by {c['bound_by']} "
            f"({100 * c['bound_ms'] / c['ms']:.1f} % of it), plain (add_ln_f32) "
            f"{c['plain_ms'] * 1e3:.1f} us, the eager add and LN it replaced "
            f"{c['library_ms'] * 1e3:.1f} us (max abs diff {c['library_max_abs_err']:.3g})")
    shares = {k: nms_call_share(dev, k) for k in (256, 512)}
    for k, c in shares.items():
        say("kernels", f"nms_padded_batched [8, 16800] -> K={k}, 64 above a frame: "
            f"{c['call_ms'] * 1e3:.1f} us a call (top-k, gathers, overlap_matrix, kernel, slot "
            f"selection), of which the greedy kernel {c['kernel_ms'] * 1e3:.1f} us "
            f"({100 * c['kernel_ms'] / c['call_ms']:.0f} %); {c['wall_ms'] * 1e3:.0f} us a call "
            "on the host's clock")
    one = torch.zeros(1, device=dev)
    say("kernels", "for scale, a one-element add timed the same way (a launch and the "
        f"events around it): {device_ms(lambda: one.add_(1.0)) * 1e3:.1f} us")

    scan = run_scan(dev, scenes, PROFILE, TICKS, WARM)
    say("engine", f"default profile, {FRAMES} x 640 I420 delta stream, {TICKS} ticks "
        f"after the keyframe: {scan['batches']} batches, launches {scan['launches']}, bn_act "
        f"{chain_text(scan['chains'], 'iresnet forwards: the embedder is MobileFaceNet')}")
    say("engine", f"steady state over {TICKS + 1 - WARM} ticks (submit then fetch): "
        f"{scan['frames_per_s']:.1f} frames/s, {scan['faces_per_s']:.1f} faces/s, "
        f"{scan['faces_per_batch']:.2f} faces/batch, {scan['ms_per_batch']:.2f} ms/batch")
    say("engine", f"stage ms (device, median of {SYNC_BATCHES} steady batches, the stage spans): "
        + ", ".join(f"{k} {v:.3f}" for k, v in scan["stage_ms"].items()))
    say("engine", f"resident batch == apply_host; enrolled face of frame "
        f"{scan['enrolled_frame']} matched at distance {scan['enrolled_distance']:.4f}")
    say("engine", f"submit_encoded {scan['submit_ms']:.2f} ms (host clock, median over the steady "
        f"ticks); host syncs of {SYNC_BATCHES} steady batches (torch's sync debug mode): submit "
        f"{scan['syncs']['submit']}, fetch {scan['syncs']['fetch']}; in the spans, all "
        f"{SYNC_BATCHES}: {scan['span_syncs']}; embed rungs {scan['embed']} (speculated from "
        f"landed counts, redone in a fetch, whole batch, slots embedded); on {smi}")

    nms = run_nms_engine(dev, scenes, PROFILE)
    say("nms", f"pre_nms_topk=512: launches {nms['launches']}, {nms['faces']} faces")

    par = run_parity(dev, scenes[:2], PROFILE)
    say("parity", f"f32, TF32 off, 2 frames, {par['faces']} faces: valid, count, best_idx "
        "equal on cuda and cpu; max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in par["max_abs_err"].items()))

    fused = run_fused(dev, scenes, PROFILE, scan["engine"], scan["enrolled_frame"])
    say("fused", f"build_pipeline, {FRAMES} x 640 uint8 RGB, {fused['calls']} calls: launches "
        f"{fused['launches']} (one greedy_nms and one warp_crops a call, no detection_head)")
    say("fused", f"{fused['faces']} faces: valid, count, best_idx equal to the staged engine's; "
        "max abs err " + ", ".join(f"{k} {v:.3g}" for k, v in fused["max_abs_err"].items())
        + f"; enrolled face matched at distance {fused['enrolled_distance']:.4f}")
    say("fused", f"{fused['ms_per_call']:.2f} ms a call (host clock, synchronized) on {smi}")

    acc = run_accuracy(dev, scenes, TICKS, WARM, scan["engine"])
    say("accuracy", f"iresnet18 + flip-TTA, distance scale {acc['engine'].distance_scale}, "
        f"{FRAMES} x 640 I420 delta stream, {TICKS} ticks after the keyframe: "
        f"{acc['batches']} batches with the compaction runs, launches {acc['launches']}, bn_act "
        f"{chain_text(acc['chains'], 'iresnet18 forwards of 17')}")
    say("accuracy", f"steady state over {TICKS + 1 - WARM} ticks (submit then fetch): "
        f"{acc['frames_per_s']:.1f} frames/s, {acc['faces_per_s']:.1f} faces/s, "
        f"{acc['faces_per_batch']:.2f} faces/batch, {acc['ms_per_batch']:.2f} ms/batch")
    say("accuracy", "stage ms (device, median): "
        + ", ".join(f"{k} {v:.3f}" for k, v in acc["stage_ms"].items()))
    say("accuracy", f"resident batch == apply_host; enrolled face of frame "
        f"{acc['enrolled_frame']} matched at distance {acc['enrolled_distance']:.4f}")
    for name, comp in (("accuracy", acc["compaction"]), ("default", acc["default_compaction"])):
        say("accuracy", f"{name} profile, compaction on against FRP_EMBED_COMPACT=0 on one batch, "
            f"{comp['faces']} faces: valid, count, best_idx equal; max abs err "
            + ", ".join(f"{k} {v:.3g}" for k, v in comp["max_abs_err"].items()))
        for key in ("on", "off"):
            b, busy = comp["bound"][key], comp["busy_ms"][key]
            say("accuracy", f"{name} profile, compaction {key}: embed device ms "
                + ", ".join(f"{x:.3f}" for x in comp["embed_ms"][key])
                + "; stream ms/batch " + ", ".join(f"{x:.2f}" for x in comp["stream_ms_per_batch"][key])
                + "; device busy " + ("not measured (no device activity in the trace)" if busy is None
                                      else f"{busy:.3f} ms/batch (torch.profiler), idle "
                                      f"{1 - busy / np.median(comp['stream_ms_per_batch'][key]):.2f} "
                                      "of the unprofiled streams' median ms/batch")
                + f"; embed {b['faces']} faces of {b['slots']} slots, {b['rung']} run, "
                f"{b['flops'] / 1e12:.4f} TFLOP, {b['bytes'] / 1e6:.1f} MB, bound {b['bound_ms']:.3f} ms "
                f"by {b['bound_by']} (bf16 989 TFLOP/s, 3.35 TB/s)")
    apar = run_parity(dev, scenes[:2], {**ACCURACY, "max_faces_per_frame": 4})
    say("accuracy", f"parity f32, TF32 off, 2 frames, 4 slots, {apar['faces']} faces: valid, count, "
        "best_idx equal on cuda and cpu; max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in apar["max_abs_err"].items()))

    piped = run_pipelined(dev, scenes, PROFILE, TICKS)
    say("pipelined", f"default profile, {TICKS + 1} payloads four times (serial, pipelined, "
        f"pipelined, serial), precompile_delta_rungs {piped['rungs']} rungs after the first: "
        f"launches {piped['launches']}, desyncs 0")
    say("pipelined", "put_payload thread + submit_encoded + fetch_many(4) equal submit then fetch "
        "(valid, count, best_idx, is_match bit for bit); max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in piped["max_abs_err"].items()))
    for way in ("serial", "piped"):
        say("pipelined", f"{way} over {piped['steady']} batches: frames/s "
            + ", ".join(f"{x:.1f}" for x in piped["frames_per_s"][way]) + "; ms/batch "
            + ", ".join(f"{x:.2f}" for x in piped["ms_per_batch"][way]))
    say("pipelined", f"phase 4: {scan['frames_per_s']:.1f} frames/s ({scan['ms_per_batch']:.2f} "
        f"ms/batch); on {smi}")

    t_platform = time.perf_counter()
    plat = run_platform(dev)
    say("platform", f"AppContext, default config, {PLATFORM_CAMERAS} cameras synthetic "
        f"{PLATFORM_SOURCE[0]}x{PLATFORM_SOURCE[1]}: dry run_scan {plat['warm_s']:.2f} s, camera 0's "
        f"face enrolled (score {plat['enrol_score']:.3f}), {plat['requests']} GET /camera/alerts "
        f"over the socket: launches {plat['launches']}")
    say("platform", f"every scan scanned {PLATFORM_CAMERAS} cameras; faces a scan "
        f"{plat['faces_per_scan']:.2f} (least {plat['min_faces']}); the enrolled face matched on "
        f"camera 0 in every scan at {plat['camera0_distance'][0]:.4f}-{plat['camera0_distance'][1]:.4f} "
        f"(tolerance {plat['tolerance']}); {plat['tracking']} tracking records and {plat['logged']} "
        f"alert logs in the store, {plat['alerts']} alerts, {plat['pushed']} new_alert events on the "
        f"socket; delta_stats {plat['delta']}")
    say("platform", f"{plat['scans_per_s']:.2f} scans/s, {plat['frames_per_s']:.1f} frames/s; "
        f"ms a scan (host clock) median {plat['scan_ms']:.1f}, mean {plat['scan_ms_mean']:.1f}, GET round trip "
        f"{plat['get_ms']:.1f}; device ms a scan (median) "
        + ("not measured" if plat["device_ms"] is None else f"{plat['device_ms']:.3f}")
        + "; host parts (mean ms) " + ", ".join(f"{k} {v:.2f}" for k, v in plat["parts_ms"].items())
        + "; stage ms (device, median) " + ", ".join(f"{k} {v:.3f}" for k, v in plat["stage_ms"].items())
        + f"; delta payload {plat['payload_kb']:.1f} KiB (median); on {smi}")
    say("platform", f"submit {plat['parts_ms'].get('submit', float('nan')):.2f} ms a scan (mean); "
        f"host syncs of one more steady scan (dry): {plat['syncs']}; embed rungs over the "
        f"requests {plat['embed']}")
    ppar = run_platform_parity(dev)
    say("platform", f"f32, TF32 off, cuda and cpu contexts, {ppar['scans']} scans each: the same "
        f"{ppar['detections']} targets and cameras, valid, count, best_idx equal; max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in ppar["max_abs_err"].items())
        + f"; phase 10 took {time.perf_counter() - t_platform:.1f} s")

    t_services = time.perf_counter()
    srv = run_services(dev)
    v, p = srv["video"], srv["parts_ms"]
    say("services", f"POST /deepfake/detect, a {VIDEO_SIZE[0]}x{VIDEO_SIZE[1]} MJPG clip of {VIDEO_FRAMES} "
        f"frames, {srv['clip_mb']:.1f} MB (written in {srv['write_s']:.1f} s): {v['frames_sampled']} sampled, "
        f"{v['frames_with_faces']} with a face (as rendered), result {v['result']} ({v['confidence']}), "
        f"statistics {v['statistics']}; {srv['chunks']} chunks, launches {srv['video_launches']}; "
        "the same bytes again: cached, no launch")
    say("services", f"video ms (host clock): request {srv['video_wall_ms']:.1f}, service "
        f"{srv['video_ms']:.1f} = read and seek {p['read']:.1f} + letterbox {p['letterbox']:.1f} + "
        f"engine {p['engine']:.1f} + other {srv['video_ms'] - sum(p.values()):.1f}; "
        f"{srv['video_ms'] / v['frames_sampled']:.2f} ms a sampled frame; device ms a chunk "
        + ", ".join(f"{x:.3f}" for x in srv["chunk_device_ms"]) + f"; on {smi}")
    r = srv["reads"]
    say("services", f"the service read its {v['frames_sampled']} frames by seeking with cv2's "
        f"default backend ({r['default_backend']}), bit for bit the frames an in-order read "
        f"gives; the same seeks with the {r['mjpeg_backend']} "
        f"backend {r['mjpeg_seek_ms']:.1f} ms, all {r['in_order_frames']} frames in order with "
        f"the default one {r['in_order_ms']:.1f} ms (host clock) on {smi}")
    say("services", f"POST /deepfake/detect-image: {srv['image']['result']} "
        f"({srv['image']['faces']} faces); GET /deepfake/cctv?max_frames={CCTV_FRAMES} over "
        f"{PLATFORM_CAMERAS} cameras {srv['cctv_ms']:.1f} ms (host clock) on {smi}: "
        + ", ".join(f"{k} {c['real']}/{c['fake']}/{c['no_faces']}" for k, c in srv["cctv"].items())
        + " (real/fake/no face)")
    say("services", f"async search matched {ENROLLED} at distance {srv['job_distance']:.4f}; FL "
        f"aggregate of 2 clients equals the numpy mean bit for bit ({srv['fl_layers']} layers); "
        f"snapshot 200 with an ETag, then 304; /app and /dashboard 200; launches {srv['launches']}")
    f = srv["f32"]
    say("services", f"f32, TF32 off, cuda against cpu on the {v['frames_sampled']} sampled frames: "
        f"faces equal, verdict {f['result']} on both ({f['confidence'][0]}, {f['confidence'][1]}; "
        f"mean fake_prob {f['mean'][0]}, {f['mean'][1]}); max abs err fake_prob "
        f"{f['fake_prob']:.3g}, boxes {f['box_px']:.3g} px")
    for name in ("scenes", "video"):
        b = srv["bf16"][name]
        say("services", f"bf16 default engine, cuda against cpu at bf16, {name}: {b['frames']} frames, "
            f"{b['slots']} faces; valid differ {b['valid_diff']}, count differ {b['count_diff']}; "
            f"faces off the cpu's bf16 (box > 1 px, cosine < 0.99 or fake_prob > 0.02) "
            f"{b['off_bf16']} of {b['slots']}, of which with the same kept anchor "
            f"{b['off_same_anchor']}; anchor flips {b['anchor_flips']} (not a near tie "
            f"{b['flips_not_tied']}); best_idx differ "
            f"{b['best_idx_diff']} of {b['slots']} ({b['best_idx_clear_diff']} of "
            f"{b['best_idx_clear']} agreeing faces with a clear margin); per-frame verdicts flipped "
            f"{b['frame_verdict_flips']}; min cosine {b['cos_min']:.5f}, max abs err boxes "
            f"{b['box_px']:.3g} px, fake_prob {b['fake_prob']:.3g}, distance {b['distance']:.3g}"
            + "".join(f"; anchor flip: {u}" for u in b["flips"]))
    say("services", f"bf16 video verdicts: {srv['bf16']['verdicts'][0]} on cuda, "
        f"{srv['bf16']['verdicts'][1]} on cpu; phase 11 took {time.perf_counter() - t_services:.1f} s")

    t_train = time.perf_counter()
    tr = run_train(dev, scenes, scan["engine"])
    for name, r in tr["arcface"].items():
        say("train", f"ArcFace {name}, bf16, {TRAIN_IDS} identities, batch "
            f"{BIG_BATCH if name.endswith(f'b{BIG_BATCH}') else TRAIN_BATCH}, lr {TRAIN_LR}, margin 0.5, one fixed "
            f"batch ({r['render_ms']:.1f} ms to render on the host): loss {r['loss'][0]:.3f} -> "
            f"{r['loss'][1]:.3f} over {TRAIN_STEPS} steps")
        say("train", f"ArcFace {name}: step {r['ms']:.2f} ms (CUDA events, median after {TRAIN_WARM}), "
            f"{r['host_ms']:.2f} ms (synchronized host clock); {r['images_per_s']:.0f} images/s; "
            f"{r['flops'] / 1e12:.4f} TFLOP a step (FlopCounterMode, forward and backward), "
            f"{r['bytes'] / 1e6:.1f} MB; bound {r['bound_ms']:.3f} ms by {r['bound_by']} (bf16 989 "
            f"TFLOP/s, 3.35 TB/s), {100 * r['share']:.1f} % of it; device busy "
            + ("not measured" if r["busy_ms"] is None else
               f"{r['busy_ms']:.2f} ms a step (torch.profiler), idle {r['idle']:.2f}")
            + f"; peak memory {r['peak_gb']:.2f} GB; on {smi}")
        say("train", f"ArcFace {name}: top kernels (device ms a step, share of busy) "
            + "; ".join(f"{k} {ms:.2f} ({100 * sh:.0f} %)" for k, ms, sh in r["top"]))
    for name in ("spoof", "detector"):
        r = tr[name]
        say("train", f"{name} trainer ({'batch 64 at 112' if name == 'spoof' else 'det 320, batch 16, mix'}"
            f", {r['render_ms']:.0f} ms to render): loss {r['loss'][0]:.3f} -> {r['loss'][1]:.3f} over "
            f"{TRAIN_STEPS} steps; step {r['ms']:.2f} ms (events), {r['host_ms']:.2f} ms (host); "
            f"{r['flops'] / 1e12:.4f} TFLOP, bound {r['bound_ms']:.3f} ms by {r['bound_by']}, "
            f"{100 * r['share']:.2f} % of it; device busy "
            + ("not measured" if r["busy_ms"] is None else f"{r['busy_ms']:.2f} ms, idle {r['idle']:.2f}")
            + f"; peak memory {r['peak_gb']:.2f} GB; top kernels "
            + "; ".join(f"{k} {ms:.2f} ({100 * sh:.0f} %)" for k, ms, sh in r["top"]))
    for name, e in tr["parity"].items():
        say("train", f"parity f32, TF32 off, {name}: one step on cuda and on the cpu, max errors "
            + ", ".join(f"{k} {v:.3g}" for k, v in e.items()))
    sv = tr["serve"]
    say("train", f"the trained MobileFaceNet (save_params) served: process_frames over {FRAMES} "
        f"scenes, {sv['faces']} faces, valid and count equal to phase 4's engine, kernels 1 and 2 "
        f"once; embed_scenes embedded {sv['scenes']} of {FRAMES} scenes; embeddings moved "
        f"{sv['moved']:.3f} from the shipped weights'; launches {sv['launches']}")
    fl = tr["fl"]
    say("train", f"FL: two fl_client runs (5 steps each) uploaded {fl['layers']} layers "
        f"({fl['params']} values) each to the port's server; the aggregate equals the numpy mean "
        f"bit for bit under the JAX layer names; {fl['seconds']:.1f} s; losses "
        + "; ".join(", ".join(f"{x:.2f}" for x in l) for l in fl["losses"])
        + f"; phase 12 took {time.perf_counter() - t_train:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in tr["seconds"].items()) + ")")

    t_import = time.perf_counter()
    imp = run_imported(dev, scenes, TICKS, WARM)
    sc, oc, tl = imp["scan"], imp["onnx_scan"], imp["tools"]
    say("imported", f"weights dirs written in {imp['write_s']:.1f} s: a seeded w600k-style "
        f"embedder.onnx ({IMPORTED['embedder_arch']}, {IMPORTED['embed_dim']}-d, "
        f"{imp['embedder_mb']:.1f} MB), and retinaface.onnx and spoof.onnx from the shipped npz")
    say("imported", "tools on the card, run at once (wall s): "
        + ", ".join(f"{k} {v:.1f}" for k, v in tl["seconds"].items())
        + f"; dry run of the detector and spoof exports passed; the {IMPORTED['embed_dim']}-d "
        f"embedder refused at 128-d as the reference's tool does ({tl['refused'][:120]}); "
        f"calibrate_embedder {' '.join(TOOL_SIZE)}: scale {tl['scale']}, {tl['detected']} scenes, "
        f"backend {tl['backend']}; tiered_eval recall by tier {tl['recall']}")
    for name, par in imp["parity"].items():
        say("imported", f"{name}: parity f32, TF32 off, scenes {PARITY_SCENES}, 4 slots, {par['faces']} faces: "
            "valid, count, best_idx equal on cuda and cpu; max abs err "
            + ", ".join(f"{k} {v:.3g}" for k, v in par["max_abs_err"].items()))
    b = imp["bf16"]
    say("imported", f"mixed, bf16 against the cpu at bf16, {b['frames']} frames, {b['slots']} "
        f"faces: valid differ {b['valid_diff']}, count differ {b['count_diff']}, off {b['off_bf16']} "
        f"(same anchor {b['off_same_anchor']}), anchor flips {b['anchor_flips']} (not a near tie "
        f"{b['flips_not_tied']}), best_idx differ {b['best_idx_diff']}; min cosine "
        f"{b['cos_min']:.5f}, boxes {b['box_px']:.3g} px")
    say("imported", f"(a) embedder.onnx + npz detector and spoof ('same' padding kept), "
        f"{FRAMES} x 640 I420 delta stream, {TICKS} ticks: steady {sc['frames_per_s']:.1f} "
        f"frames/s, {sc['faces_per_batch']:.2f} faces/batch, {sc['ms_per_batch']:.2f} ms/batch; "
        "stage ms (device, median) " + ", ".join(f"{k} {v:.3f}" for k, v in sc["stage_ms"].items())
        + f"; enrolled face of frame {sc['enrolled_frame']} matched at {sc['enrolled_distance']:.4f}")
    comp = imp["compaction"]
    for key in ("on", "off"):
        bd, busy = comp["bound"][key], comp["busy_ms"][key]
        say("imported", f"(a) compaction {key}: embed device ms "
            + ", ".join(f"{x:.3f}" for x in comp["embed_ms"][key])
            + "; stream ms/batch " + ", ".join(f"{x:.2f}" for x in comp["stream_ms_per_batch"][key])
            + "; device busy " + ("not measured (no device activity in the trace)" if busy is None
                                  else f"{busy:.3f} ms/batch (torch.profiler), idle "
                                  f"{1 - busy / np.median(comp['stream_ms_per_batch'][key]):.2f}")
            + f"; embed {bd['faces']} faces of {bd['slots']} slots, {bd['rung']} run, "
            f"{bd['flops'] / 1e12:.4f} TFLOP a batch (FlopCounterMode), bound {bd['bound_ms']:.3f} ms "
            f"by {bd['bound_by']} (bf16 989 TFLOP/s, 3.35 TB/s), "
            f"{100 * bd['bound_ms'] / np.median(comp['embed_ms'][key]):.1f} % of it")
    say("imported", f"(b) all three from ONNX ('torch' padding): {oc['faces_per_batch']:.2f} "
        f"faces/batch, {oc['ms_per_batch']:.2f} ms/batch; stage ms (device, median) "
        + ", ".join(f"{k} {v:.3f}" for k, v in oc["stage_ms"].items())
        + f"; launches {imp['launches']} over {imp['batches']} batches (kernels 1 and 2 once a "
        f"batch), bn_act {chain_text(imp['chains'], 'iresnet50 forwards of 49')}; "
        f"phase 13 took {time.perf_counter() - t_import:.1f} s on {smi}")

    t_mesh = time.perf_counter()
    me = run_mesh_engine(dev, scenes, TICKS, WARM)
    say("mesh", f"(a) the engine over a mesh of the card x {MESH_DATA} (default profile, "
        f"{FRAMES // MESH_DATA} frames a shard), phase 4's stream, {TICKS} ticks: launches "
        f"{me['stream_launches']} over {me['batches']} batches (kernels 1 and 2 once a shard); "
        f"steady {me['frames_per_s']:.1f} frames/s, {me['faces_per_batch']:.2f} faces/batch, "
        f"{me['ms_per_batch']:.2f} ms/batch against phase 4's {scan['ms_per_batch']:.2f}; host "
        f"syncs of a steady batch (torch's sync debug mode) sharded {me['syncs']['sharded']}, "
        f"unsharded {me['syncs']['unsharded']}")
    b = me["bf16"]
    say("mesh", f"(a) bf16, sharded against unsharded on the card, {b['frames']} frames, "
        f"{b['slots']} faces, gallery {me['gallery']}: valid differ {b['valid_diff']}, count "
        f"differ {b['count_diff']}, off {b['off_bf16']} (same anchor {b['off_same_anchor']}), "
        f"anchor flips {b['anchor_flips']} (not a near tie {b['flips_not_tied']}), best_idx "
        f"differ {b['best_idx_diff']}; min cosine {b['cos_min']:.5f}, boxes {b['box_px']:.3g} px; "
        f"f32, TF32 off, 3 payloads, {me['f32_faces']} faces: valid, count, best_idx equal; max "
        "abs err " + ", ".join(f"{k} {v:.3g}" for k, v in me["f32_max_abs_err"].items())
        + "; at f32 B=1 and B=3 (rows the data axis does not divide; RGB, a keyframe and a "
        "delta) equal to the unsharded engine, faces "
        + ", ".join(f"B={b} {n}" for b, n in me["uneven_faces"].items()))
    mt = run_mesh_train(dev)
    rs = mt["rank_seconds"]
    say("mesh", f"(b) {MESH_RANKS} gloo processes on the card, a {mt['shapes']['mesh']} process "
        f"mesh ({mt['seconds']:.1f} s with their start; the ranks entered at "
        + ", ".join(f"{x:.1f}" for x in rs["entered"]) + " s, rank 0's s by part "
        + ", ".join(f"{k} {v:.1f}" for k, v in rs.items() if k != "entered")
        + f"): ArcFace classifier shard "
        f"{mt['shapes']['classifier']}, saved whole {mt['ckpt_shape']} and restored on every "
        "rank; f32 steps against one process on the card, max errors "
        + "; ".join(f"{n} " + ", ".join(f"{k} {v:.3g}" for k, v in e.items())
                    for n, e in mt["held"].items()))
    say("mesh", f"(b) bf16 ArcFace MobileFaceNet, batch {TRAIN_BATCH} over the mesh: loss "
        f"{mt['loss'][0]:.3f} -> {mt['loss'][1]:.3f} over {MESH_STEPS} steps; {mt['ms']:.2f} ms a "
        f"step (rank 0's synchronized host clock, median after {TRAIN_WARM}) against phase 12's "
        f"{tr['arcface']['mobilefacenet']['host_ms']:.2f} on one process")
    nc = run_nccl_rank(dev)
    say("mesh", f"(c) a one-rank NCCL group ({nc['seconds']:.1f} s with its start; s by part "
        + ", ".join(f"{k} {v:.1f}" for k, v in nc["rank_seconds"].items() if k != "entered")
        + "): the f32 ArcFace step against one process, max errors "
        + ", ".join(f"{k} {v:.3g}" for k, v in nc["held"]["arcface_mobilefacenet"].items())
        + f"; bf16 at batch {TRAIN_BATCH}: loss {nc['loss'][0]:.3f} -> {nc['loss'][1]:.3f}, "
        f"{nc['ms']:.2f} ms a step over the one-rank mesh, {nc['alone']['ms']:.2f} without a "
        f"mesh in the same process, phase 12's {tr['arcface']['mobilefacenet']['host_ms']:.2f}")
    fl = run_mesh_fl(dev)
    say("mesh", f"(d) the FL service over the mesh: backend {fl['backend']}, {fl['layers']} layers, "
        f"the f32 mean bit for bit, {fl['rel']:.3g} from the numpy mean; phase 14 took "
        f"{time.perf_counter() - t_mesh:.1f} s on {smi}")

    t_host = time.perf_counter()
    ticks = render_hintless()
    render_s = time.perf_counter() - t_host
    fp = run_framepack(ticks)
    say("host", f"(a) framepack built by g++ from frp_tpu_torch/csrc/framepack.cpp into "
        f"{fp['path']}; {fp['frames']} frames of {PLATFORM_SOURCE[0]}x{PLATFORM_SOURCE[1]} "
        f"(ticks 0 and 1), det {PROFILE['det_size']}, {fp['rows']} active rows: "
        "letterbox_i420_batch equals letterbox_i420, delta_blocks the numpy search (count "
        f"{fp['count']}, fill at cap {fp['cap']} of {fp['block']}-byte blocks), dirty_bands the "
        f"numpy band diff (changed rows a frame {fp['dirty_rows']}) and its updated previous "
        "frame the current one, bit for bit")
    say("host", "(a) host ms for the 8 frames, native against numpy: "
        + ", ".join(f"{k} {a:.2f} against {b:.2f}" for k, (a, b) in fp["ms"].items())
        + f"; on {smi}")
    hl = run_hintless(dev, ticks)
    say("host", f"(b) AppContext, default config, {PLATFORM_CAMERAS} PushSource cameras "
        f"{PLATFORM_SOURCE[0]}x{PLATFORM_SOURCE[1]} without change hints, {hl['scans']} ticks "
        f"rendered first ({render_s:.1f} s; camera {STATIC_CAMERA} static, camera {CUT_CAMERA} "
        f"cut at tick {CUT_TICK}), pushed then run_scan: launches {hl['launches']}; every scan's "
        "batch rebuilt from its payloads equals build_batch_i420 of its frames and the resident "
        f"batch; faces a scan {hl['faces_per_scan']:.2f}, camera 0's enrolled face matched at "
        f"{hl['camera0_distance'][0]:.4f}-{hl['camera0_distance'][1]:.4f}; delta_stats "
        f"{hl['delta']}; the static slot's delta hint [] and every other slot's block ranges "
        f"from tick 1 on ({hl['cut_blocks']} blocks at the cut)")
    say("host", f"(b) over ticks 1-{hl['scans'] - 1}: letterbox {hl['letterbox_ms']:.2f} ms a scan "
        f"(the scan's timer, mean), of which build_batch_i420_cached (the change detector and "
        f"the banded letterbox) median {hl['cached_ms'][0]:.2f}, mean {hl['cached_ms'][1]:.2f}, "
        f"against build_batch_i420 of the same frames median {hl['full_ms'][0]:.2f}, mean "
        f"{hl['full_ms'][1]:.2f}; scan parts (mean ms) "
        + ", ".join(f"{k} {v:.2f}" for k, v in hl["parts_ms"].items())
        + f"; payload {hl['payload_kb']:.1f} KiB a scan (median, largest {hl['payload_kb_max']:.1f}); "
        f"{hl['scans_per_s']:.2f} scans/s; on {smi}")
    mx = hl["mixed"]
    say("host", f"(b) mixed hints, a synthetic camera read by a probe before scans 1, 2, 7 and 8: "
        f"{mx['scans']} scans ({', '.join(mx['kinds'])}), each cached batch equal to a full "
        "letterbox (no ghost)")
    sw = run_switches(dev, scenes[:2])
    for name, h in sw["held"].items():
        say("host", f"(c) {name}, f32, TF32 off, {h['faces']} faces: valid, count, best_idx equal "
            "on cuda and cpu, the outputs switched off absent; max abs err "
            + ", ".join(f"{k} {v:.3g}" for k, v in h["max_abs_err"].items()))
    say("host", f"(c) launches {sw['launches']} (build_pipeline: greedy_nms and warp_crops once a "
        "call; the engine: detection_head and warp_crops once a batch)")
    sf = run_stage_flops({
        "default": (scan["engine"], round(scan["faces_per_batch"]),
                    acc["default_compaction"]["busy_ms"]["on"], scan["ms_per_batch"]),
        "accuracy": (acc["engine"], round(acc["faces_per_batch"]),
                     acc["compaction"]["busy_ms"]["on"], acc["ms_per_batch"]),
    })
    for name, f in sf.items():
        say("host", f"(d) {name} profile, {FRAMES} frames a batch, {f['occupancy']} faces (phase "
            f"{4 if name == 'default' else 8}'s): engine_stage_flops GFLOP "
            + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in f["flops"].items())
            + f" (FlopCounterMode; embed at the rung of {f['occupancy']} faces); MFU at bf16 "
            f"{PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s: over device-busy "
            + ("not measured" if f["mfu_busy"] is None else
               f"{f['busy_ms']:.3f} ms {100 * f['mfu_busy']:.3f} %")
            + f", over {f['ms_per_batch']:.2f} ms/batch {100 * f['mfu_wall']:.3f} %; on {smi}")
    say("host", f"phase 15 took {time.perf_counter() - t_host:.1f} s")

    t_entry = time.perf_counter()
    ent = run_entry(dev)
    say("entry", f"testing/entry.py (the twin of __graft_entry__.entry()): one fn(*example_args) "
        f"launched {ent['once']}; 14 results, finite, count {ent['count']}; "
        f"{ent['ms']:.2f} ms a call over {ENTRY_CALLS} calls (host clock, synchronized); launches "
        f"{ent['launches']}")
    say("entry", f"f32, TF32 off, cuda against cpu, {ent['f32_faces']} faces: valid and count equal; "
        "max abs err " + ", ".join(f"{k} {v:.3g}" for k, v in ent["f32_max_abs_err"].items()))
    for name, c in ent["kernels"].items():
        say("entry", f"{name} at the entry's shape {c['shape']}: equal to plain (max abs err "
            f"{c['max_abs_err']:.3g}); kernel {c['ms'] * 1e3:.1f} us, bound {c['bound_ms'] * 1e3:.3f} "
            f"us by {c['bound_by']}, plain {c['plain_ms'] * 1e3:.1f} us"
            + (f", grid_sample {c['library_ms'] * 1e3:.1f} us" if c["library_ms"] is not None else "")
            + f"; on {smi}")
    say("entry", f"phase 16 took {time.perf_counter() - t_entry:.1f} s")

    t_bench = time.perf_counter()
    bn = run_bench(dev)
    d = bn["detail"]
    say("bench", f"python -m frp_tpu_torch.bench --once, BENCH_WINDOWS=1 BENCH_TICKS={BENCH_TICKS} "
        f"(the rest at their defaults: depth {d['pipeline_depth']}, group {d['fetch_group']}), "
        f"{bn['seconds']:.1f} s: {bn['out']['value']} faces/s ({bn['out']['metric']})")
    say("bench", f"{d['ms_per_batch']} ms/batch over {d['batches']} batches of "
        f"{FRAMES * BENCH_TICKS} frames, {d['frames_per_sec']} frames/s; faces a batch "
        f"{d['faces_per_batch']} of {bn['want']} rendered"
        + ("" if bn["f32_faces"] is None else f" (the f32 engine: {bn['f32_faces']})")
        + f"; p50 detection-to-alert {d['p50_detection_to_alert_ms']} ms (samples "
        f"{d['detection_to_alert_ms']})")
    say("bench", f"device {d['device_ms_per_batch']} ms/batch (20 stage runs, one sync), busy "
        f"{d['device_busy_ms_per_batch']} ms (torch.profiler), duty cycle "
        f"{d['device_duty_cycle']}; host producer {d['host_producer_ms_per_batch']} ms, transfer "
        f"{d['host_transfer_ms_per_batch']} ms a batch; GFLOP {d['stage_gflops']}; MFU device "
        f"{d['mfu_device']}, busy {d['mfu_busy']}, serving {d['mfu_serving']} at "
        f"{d['peak_flops_assumed'] / 1e12:.0f} TFLOP/s")
    say("bench", f"wire {d['wire_shipped_mb']} of {d['wire_raw_equiv_mb']} MB "
        f"({d['wire_compression_ratio']}x), keyframes {d['keyframe_batches']}, deltas "
        f"{d['delta_batches']}; embed rungs {d['embed_compact_rungs']}, embed_stats "
        f"{d['embed_stats']} (timed {d['embed_stats_timed']}); resident batch equal to the "
        f"producer's last batch after {d['resident_check']['payloads']} payloads; launches "
        f"{bn['launches']}; on {d['device']}")
    bk = hold_bench_kernels(dev)
    for name, c in bk["kernels"].items():
        say("bench", f"{name} at the bench's shape {c['shape']} (its batch with the walker through "
            f"the default engine here, {bk['faces']} faces): equal to plain (max abs err "
            f"{c['max_abs_err']:.3g}); kernel {c['ms'] * 1e3:.1f} us, bound {c['bound_ms'] * 1e3:.3f} "
            f"us by {c['bound_by']}, plain {c['plain_ms'] * 1e3:.1f} us"
            + (f", grid_sample {c['library_ms'] * 1e3:.1f} us" if c["library_ms"] is not None else "")
            + f"; on {smi}")
    say("bench", f"phase 17 took {time.perf_counter() - t_bench:.1f} s")

    t_diag = time.perf_counter()
    dg = run_diagnostics(dev)
    for (name, dtype), r in dg["runs"].items():
        on = "cpu, f32" if dtype == "cpu" else f"cuda, {'f32, TF32 off' if dtype == 'float32' else 'bf16'}"
        say("diagnostics", f"{name} {' '.join(dg['size'] + DIAG_TOOLS[name])} ({on}): "
            f"{r['seconds']:.1f} s, launches {r['launches']}, bn_act "
            f"{chain_text(r['chains'], 'iresnet forwards')}; "
            f"{diag_summary(name, r['report'])}"
            + ("" if dtype == "cpu" else f"; on {smi}"))
        say("diagnostics", f"{name} ({on}) report: {json.dumps(r['report'])}")
    for name, h in dg["held"].items():
        say("diagnostics", f"{name}: the f32 card run equals the cpu run in every count (detected, "
            f"common, n_same, n_diff); max abs err landmark {h['max_abs_err']['landmark_px']:.3g} px, "
            f"AUC, EER and medians {h['max_abs_err']['metrics']:.3g}; rates beside a pair distance "
            f"within {DIAG_TOL} of 0.4 or 0.6 (not held): {h['near'] or 'none'}")
    say("diagnostics", f"phase 18 took {time.perf_counter() - t_diag:.1f} s")

    counts = {name: sum(ph["launches"][name]
                        for ph in (scan, nms, fused, acc, piped, plat, srv, tr, imp, me, hl, sw, ent, bn,
                                   dg))
              for name in launches()}

    def kernel_row(k: cuda_build.Kernel, **fields) -> dict:
        return {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
                **fields}

    ported = {name: kernel_row(k, launches=counts[name], **{key: checks[name][key] for key in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        for name, k in kernels().items() if k.replaces}
    # kernel 1 on its second input, all 256 candidates above in a crowd
    ported["detection_head"].update(ms_all_above=crowd["ms"], plain_ms_all_above=crowd["plain_ms"],
                                    max_abs_err_all_above=crowd["max_abs_err"])
    # kernel 3 at K=256 and K=1024, all above in a crowd, and 10 % above
    ported["greedy_nms"].update({key: c["ms"] for key, c in greedy.items()})
    ported["greedy_nms"].update({f"nms_call_ms_k{k}": c["call_ms"] for k, c in shares.items()})
    rows = list(ported.values())
    # kernels 2 and 3 at the entry's shapes (phase 16) and kernels 1 and 2 at
    # the bench's (phase 17), each with its phase's launches
    for key, ph, held in (("entry", ent, ent["kernels"]), ("bench", bn, bk["kernels"])):
        for row in rows:
            if row["name"] in held:
                c = held[row["name"]]
                row[key] = {"shape": c["shape"], "launches": ph["launches"][row["name"]],
                            **{k: c[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")}}
    # kernels 1 and 2 in the accuracy diagnostics' card runs (phase 18)
    for row in rows:
        row["diagnostics_launches"] = dg["launches"][row["name"]]
    # the chains' pass: no TPU kernel; its launches in the phases that run an
    # iresnet or the detector on the card, and its numbers at r50.stream's
    # and the detector's shapes (phase 3)
    rows.append(kernel_row(bn_act_cuda.KERNEL, launches={
        "engine": scan["chains"]["launches"], "accuracy": acc["chains"]["launches"],
        "imported": imp["chains"]["launches"],
        "diagnostics": sum(r["chains"]["launches"] for r in dg["runs"].values())}, **chains))
    # the add-LN pass: no TPU kernel, and no phase runs a ViT or a Swin
    # forward; its numbers at vitl.stream's and swint.stream's shapes (phase 3)
    rows.append(kernel_row(add_ln_cuda.KERNEL, **passes))
    say("done", f"the whole run took {time.perf_counter() - t_run:.1f} s on {smi}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
