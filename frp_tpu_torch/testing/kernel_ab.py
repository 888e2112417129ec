"""Time this tree's CUDA kernels against another checkout's, on one card in
one run (two runs may land on cards with other power limits, so only times
taken within one are compared).

    python -m frp_tpu_torch.testing.kernel_ab --other path/to/other/checkout

from the repository root, on a machine with an NVIDIA card and nvcc. The
other checkout's ``frp_tpu_torch/csrc/*.cu`` are built with this tree's
flags; their C entry points must have this tree's signatures. Inputs are
``chip_smoke.py``'s: the detection head with 64 of 256 candidates above the
score threshold and with all 256 above in a crowd; the warp of 16 faces a
frame; the greedy kernel at K=256, 512 and 1024 with 60 % above, and at K=512
with all above in a crowd and with 10 % above. Each build is first held
against the plain version (masks and valid flags bit for bit, floats within
1e-3), then timed in the order other, this, this, other (median of 50
launches each, see ``chip_smoke.device_ms``). The other build takes the
place of this one through its declaration (``cuda_build.Kernel.using``),
which names its C entry.

``--sweep`` also times the warp on 16 faces a frame of one size and rotation,
centred in the frame, over a grid of sizes (source px an output px) and
rotations: where the two builds differ depends on both.

Prints one line per input and one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke
from frp_tpu_torch.ops import align_cuda, cuda_build, detection_cuda, kernels, nms_cuda


def start_build(root: str, name: str):
    """Start nvcc on a kernel source of the checkout at `root`, with this
    tree's flags, into this tree's build directory. Returns (process,
    library path) for ``finish_build``."""
    src = os.path.join(root, "frp_tpu_torch", "csrc", f"{name}.cu")
    out = os.path.join(cuda_build.BUILD_DIR, f"libother_{name}.so")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", out, src]
    return subprocess.Popen(cmd), out


def finish_build(started) -> str:
    proc, out = started
    if proc.wait() != 0:
        raise RuntimeError(f"nvcc failed for {out}")
    return out


def compare(name: str, declared: cuda_build.Kernel, other: dict, kernel, plain,
            flags=None) -> dict:
    """Hold both builds of one kernel against `plain()`, then time them.
    `declared` is the kernel's declaration, which `kernel()` launches;
    `other` maps a kernel's name to the path of the other checkout's
    library, whose build takes this one's place in turn: other, this, this,
    other, so each build is timed twice."""
    want = plain()
    times = {"other": [], "this": []}
    for which in ("other", "this", "this", "other"):
        with declared.using(other[declared.name]) if which == "other" else contextlib.nullcontext():
            got = kernel()
            torch.cuda.synchronize()
            if flags is not None and not torch.equal(flags(got), flags(want)):
                raise AssertionError(f"{name} ({which}): flags differ from the plain version")
            err = chip_smoke.max_err(got, want)
            if not err <= chip_smoke.ATOL:
                raise AssertionError(f"{name} ({which}): max abs err {err}")
            times[which].append(chip_smoke.device_ms(kernel))
    print(f"[ab] {name}: " + "; ".join(
        f"{which} {', '.join(f'{t * 1e3:.1f}' for t in ts)} us" for which, ts in times.items()),
        flush=True)
    return {"input": name, "ms": times}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the checkout to compare with")
    ap.add_argument("--sweep", action="store_true", help="time the warp over face sizes and rotations")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(chip_smoke.gpu_name_and_limit(), flush=True)
    # every kernel of the other checkout that this tree declares, built at once
    started = {name: start_build(args.other, name) for name in kernels()
               if os.path.exists(os.path.join(args.other, "frp_tpu_torch", "csrc", f"{name}.cu"))}
    cuda_build.build()
    other = {name: finish_build(st) for name, st in started.items()}

    rows = []
    for crowd in (False, True):
        payload = chip_smoke.head_payload(dev, crowd)
        rows.append(compare(
            "detection_head, all above in a crowd" if crowd else "detection_head, 64 of 256 above",
            detection_cuda.KERNEL, other,
            lambda: detection_cuda.fused_head_kernel(payload, *chip_smoke.HEAD_ARGS),
            lambda: detection_cuda.fused_head_plain(payload, *chip_smoke.HEAD_ARGS),
            flags=lambda out: out[..., 15]))
    scenes = chip_smoke.render_scenes(chip_smoke.FRAMES, chip_smoke.PROFILE["det_size"], chip_smoke.SEED)
    frames = torch.from_numpy(scenes).to(dev)
    inv = chip_smoke.warp_faces(dev, *frames.shape[:3])
    rows.append(compare(
        "warp_crops, 8 x 640 x 640, 16 faces, S=112", align_cuda.KERNEL, other,
        lambda: align_cuda.warp_crops_kernel(frames, inv, 112),
        lambda: align_cuda.warp_crops_plain(frames, inv, 112)))
    if args.sweep:
        b, h, w = frames.shape[:3]
        centre = np.broadcast_to(np.array([w / 2, h / 2]), (b, 16, 2))
        for px in (0.5, 1.0, 1.67, 2.5, 4.0):
            for th in (0.0, 0.35, 0.7):
                mats = chip_smoke.face_matrices(np.full((b, 16), th), np.full((b, 16), 1 / px), centre, 112)
                one = chip_smoke.invert_similarity(torch.from_numpy(mats).to(dev))
                rows.append(compare(
                    f"warp_crops, faces of {px:g} source px an output px turned {th:g} rad",
                    align_cuda.KERNEL, other,
                    lambda: align_cuda.warp_crops_kernel(frames, one, 112),
                    lambda: align_cuda.warp_crops_plain(frames, one, 112)))
    for k, case in ((256, "smoke"), (512, "smoke"), (1024, "smoke"), (512, "crowd"), (512, "sparse")):
        eff, above = chip_smoke.greedy_input(dev, k, case)
        rows.append(compare(
            f"greedy_nms, B={eff.shape[0]} K={k}, {case}", nms_cuda.KERNEL, other,
            lambda: nms_cuda.greedy_suppress_kernel(eff, above, 1.0),
            lambda: nms_cuda.greedy_suppress_plain(eff, above, 1.0),
            flags=lambda out: out))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
