"""The whole step's share of the card's bf16 dense peak (989 TFLOP/s), in
%: the useful model FLOPs of the batches fetched in the run's window (the
detector at every frame, embedder, spoof net and match at every valid face,
counted over the benchmark's reference networks by ``perfbench/flops.py``)
over the window's seconds times the peak."""

from perfbench import flops


def read(run):
    if not run["batches"]:
        return None
    spec = run["spec"]
    f_frame, f_face = flops.per_frame_and_face(spec["config"], run["weights_dir"],
                                               run["gallery_size"])
    work = sum(run["frames_per_batch"] * f_frame + faces * f_face
               for _, _, faces in run["batches"])
    lo, hi = run["window"]
    return 100.0 * work / ((hi - lo) * flops.PEAK_BF16_DENSE)
