"""The whole step's share of the card's bf16 dense peak (989 TFLOP/s)
while the card works on a batch, in %: the useful model FLOPs of a batch
of the window (the detector at every frame, embedder, spoof net and match
at every valid face, counted over the benchmark's reference networks by
``perfbench/flops.py``) over the device seconds of a batch in the traced
slice (the kernels and copies launched inside the program's
``frp.submit_encoded`` and ``frp.redo`` spans, over its batches) times
the peak. It bounds ``faces_per_busy_s``: a kernel taken off the path
leaves its own roofline silent, and its time still counts here."""

from perfbench import flops
from perfbench.metrics._program import batches, device_us, host_events

SPANS = ("frp.submit_encoded", "frp.redo")


def read(run):
    events = host_events(run)
    if not events:
        return None
    n = batches(events)
    busy_us = sum(device_us(e) for e in events if e.name in SPANS)
    if not n or not busy_us or not run["batches"]:
        return None
    spec = run["spec"]
    f_frame, f_face = flops.per_frame_and_face(spec["config"], run["weights_dir"],
                                               run["gallery_size"])
    faces = sum(f for _, _, f in run["batches"]) / len(run["batches"])
    work = run["frames_per_batch"] * f_frame + faces * f_face
    return 100.0 * work / (busy_us / 1e6 / n * flops.PEAK_BF16_DENSE)
