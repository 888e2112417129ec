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
launches each, see ``chip_smoke.device_ms``).

``--sweep`` also times the warp on 16 faces a frame of one size and rotation,
centred in the frame, over a grid of sizes (source px an output px) and
rotations: where the two builds differ depends on both.

``--variants`` also builds this tree's greedy kernel with its compile-time
switches (``csrc/greedy_nms.cu``: blocks a frame, threads a block, the walk
left out) and times each between the two runs of "this"; a build without the
walk is timed, not checked. It prints how many clusters of each build the
card runs at once and, from the build with stop points, the SM cycles that
frame 0's first block spends in each part of one launch.

Prints one line per input and one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke
from frp_tpu_torch.ops import align_cuda, cuda_build, detection_cuda, nms_cuda

# name -> -D flags of a build of this tree's greedy_nms.cu
GREEDY_VARIANTS = {
    "cluster16": ("-DFRP_NMS_CLUSTER=16",),
    "cluster4": ("-DFRP_NMS_CLUSTER=4",),
    "cluster1_1024t": ("-DFRP_NMS_CLUSTER=1", "-DFRP_NMS_THREADS=1024"),
    "1024t": ("-DFRP_NMS_THREADS=1024",),
    "256t": ("-DFRP_NMS_THREADS=256",),
    "one_row": ("-DFRP_NMS_ROWS=1",),
    "shared_walk": ("-DFRP_NMS_SHARED_WALK",),
    "no_walk": ("-DFRP_NMS_NO_WALK",),
    "clocks": ("-DFRP_NMS_CLOCKS",),
}
CLOCK_SPANS = ("above words", "cluster running", "own rows", "all rows landed",
               "transposes", "walk", "keep written")
UNCHECKED = ("no_walk",)


def start_build(root: str, name: str, tag: str = "other", defines=()):
    """Start nvcc on a kernel source of the checkout at `root`, with this
    tree's flags and `defines`, into this tree's build directory. Returns
    (process, library path) for ``finish_build``."""
    src = os.path.join(root, "frp_tpu_torch", "csrc", f"{name}.cu")
    out = os.path.join(cuda_build.BUILD_DIR, f"lib{tag}_{name}.so")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, *defines, "-o", out, src]
    return subprocess.Popen(cmd), out


def finish_build(started) -> ctypes.CDLL:
    proc, out = started
    if proc.wait() != 0:
        raise RuntimeError(f"nvcc failed for {out}")
    return ctypes.CDLL(out)


def compare(name: str, module, builds: dict, kernel, plain, flags=None, unchecked=()) -> dict:
    """Hold every build of one kernel against `plain()`, then time them.
    `module` is the wrapper module (``detection_cuda``, ``align_cuda``,
    ``nms_cuda``) whose entry point `kernel()` launches; `builds` maps a name
    to a C entry point ("this" is the module's own), and each takes its place
    in turn: first to last, then last to first, so every build is timed
    twice."""
    own = module._kernel()
    builds = {**builds, "this": own}
    for fn in builds.values():
        fn.argtypes, fn.restype = own.argtypes, own.restype
    want = plain()
    order = sorted(builds, key=lambda n: (n != "other", n != "this"))
    times = {which: [] for which in order}
    for which in [*order, *reversed(order)]:
        module._fn = builds[which]
        got = kernel()
        torch.cuda.synchronize()
        if which not in unchecked:
            if flags is not None and not torch.equal(flags(got), flags(want)):
                raise AssertionError(f"{name} ({which}): flags differ from the plain version")
            err = chip_smoke.max_err(got, want)
            if not err <= chip_smoke.ATOL:
                raise AssertionError(f"{name} ({which}): max abs err {err}")
        times[which].append(chip_smoke.device_ms(kernel))
    module._fn = own
    print(f"[ab] {name}: " + "; ".join(
        f"{which} {', '.join(f'{t * 1e3:.1f}' for t in ts)} us" for which, ts in times.items()),
        flush=True)
    return {"input": name, "ms": times}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the checkout to compare with")
    ap.add_argument("--sweep", action="store_true", help="time the warp over face sizes and rotations")
    ap.add_argument("--variants", action="store_true",
                    help="time the greedy kernel's compile-time variants too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(chip_smoke.gpu_name_and_limit(), flush=True)
    entries = {"detection_head": "frp_detection_head", "warp_crops": "frp_warp_crops",
               "greedy_nms": "frp_greedy_nms"}
    started = {name: start_build(args.other, name) for name in entries}
    here = os.path.dirname(cuda_build.PKG_DIR)
    variants = GREEDY_VARIANTS if args.variants else {}
    started_variants = {tag: start_build(here, "greedy_nms", tag, defines)
                        for tag, defines in variants.items()}
    cuda_build.build()
    other = {name: getattr(finish_build(started[name]), entry) for name, entry in entries.items()}
    variant_libs = {tag: finish_build(st) for tag, st in started_variants.items()}
    for tag, lib in {"this": cuda_build.load("greedy_nms"), **variant_libs}.items():
        print(f"[ab] greedy_nms {tag}: clusters the card runs at once at K=256, 512, 1024: "
              + ", ".join(str(lib.frp_greedy_nms_active_clusters(k)) for k in (256, 512, 1024)),
              flush=True)

    rows = []
    for crowd in (False, True):
        payload = chip_smoke.head_payload(dev, crowd)
        rows.append(compare(
            "detection_head, all above in a crowd" if crowd else "detection_head, 64 of 256 above",
            detection_cuda, {"other": other["detection_head"]},
            lambda: detection_cuda.fused_head_kernel(payload, *chip_smoke.HEAD_ARGS),
            lambda: detection_cuda.fused_head_plain(payload, *chip_smoke.HEAD_ARGS),
            flags=lambda out: out[..., 15]))
    scenes = chip_smoke.render_scenes(chip_smoke.FRAMES, chip_smoke.PROFILE["det_size"], chip_smoke.SEED)
    frames = torch.from_numpy(scenes).to(dev)
    inv = chip_smoke.warp_faces(dev, *frames.shape[:3])
    rows.append(compare(
        "warp_crops, 8 x 640 x 640, 16 faces, S=112", align_cuda, {"other": other["warp_crops"]},
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
                    align_cuda, {"other": other["warp_crops"]},
                    lambda: align_cuda.warp_crops_kernel(frames, one, 112),
                    lambda: align_cuda.warp_crops_plain(frames, one, 112)))
    greedy_builds = {"other": other["greedy_nms"],
                     **{tag: lib.frp_greedy_nms for tag, lib in variant_libs.items()}}
    for k, case in ((256, "smoke"), (512, "smoke"), (1024, "smoke"), (512, "crowd"), (512, "sparse")):
        eff, above = chip_smoke.greedy_input(dev, k, case)
        rows.append(compare(
            f"greedy_nms, B={eff.shape[0]} K={k}, {case}", nms_cuda, greedy_builds,
            lambda: nms_cuda.greedy_suppress_kernel(eff, above, 1.0),
            lambda: nms_cuda.greedy_suppress_plain(eff, above, 1.0),
            flags=lambda out: out, unchecked=UNCHECKED))
        if "clocks" in variant_libs:
            # the last launch of the timing above was the other build's: launch
            # the build with stop points once more and read them
            own = nms_cuda._kernel()
            nms_cuda._fn = greedy_builds["clocks"]
            nms_cuda.greedy_suppress_kernel(eff, above, 1.0)
            nms_cuda._fn = own
            stamps = (ctypes.c_longlong * 8)()
            cuda_build.check(variant_libs["clocks"].frp_greedy_nms_clocks(stamps), "clocks")
            spans = {name: stamps[i + 1] - stamps[i] for i, name in enumerate(CLOCK_SPANS)}
            rows[-1]["cycles"] = spans
            print(f"[ab]   SM cycles of frame 0's block 0, {stamps[7] - stamps[0]} in all: "
                  + ", ".join(f"{name} {n}" for name, n in spans.items()), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
