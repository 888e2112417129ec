"""The flagship forward with example arguments: the twin of the JAX
package's ``__graft_entry__.entry()``, on the card.

    from frp_tpu_torch.testing.entry import entry
    fn, args = entry()                # the card; raises without one
    out = fn(*args)                   # the 14 result tensors on the card
    fn, args = entry(device="cpu")    # the CPU, as the tests run it

``fn`` is ``build_pipeline(det_size=320, max_faces=8, pre_nms_topk=128,
with_spoof=True)`` at its bf16 default (``compute_dtype`` names another).
Its head is decode + ``nms_padded_batched``, so one call on the card
launches the greedy kernel (``csrc/greedy_nms.cu``) at K=128 and the warp
(``csrc/warp_crops.cu``) at [2, 320, 320, 3] -> [2, 8, 112, 112, 3]. The
arguments are the reference's, drawn the same way: the seeded RetinaFace,
MobileFaceNet and MobileNetV3 inits (seeds 0, 1, 2, numpy in both packages)
converted to the port's layouts, then from ``np.random.default_rng(0)`` two
noise frames and a 128 x 128 normal gallery, all of it valid, and the priors
of det 320. A random detector fills every slot on noise, so both kernels do
real work.
"""

from __future__ import annotations

import numpy as np
import torch

from frp_tpu_torch.engine.pipeline import build_pipeline, resolve_device
from frp_tpu_torch.models.mobilefacenet import init_mobilefacenet
from frp_tpu_torch.models.mobilenetv3 import init_mobilenetv3_small
from frp_tpu_torch.models.params import convert_params
from frp_tpu_torch.models.retinaface import init_retinaface
from frp_tpu_torch.ops.anchors import generate_anchors

DET_SIZE = 320  # the reference's: a small grid keeps its compile check quick
PIPELINE = dict(det_size=DET_SIZE, max_faces=8, pre_nms_topk=128, with_spoof=True)


def example_inputs() -> tuple:
    """(params, frames, gallery, gallery_valid, priors) as numpy, in the
    JAX layouts: what ``__graft_entry__.entry()`` passes."""
    params = {
        "detector": init_retinaface(0),
        "embedder": init_mobilefacenet(1),
        "spoof": init_mobilenetv3_small(2),
    }
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, size=(2, DET_SIZE, DET_SIZE, 3), dtype=np.uint8)
    gallery = rng.normal(size=(128, 128)).astype(np.float32)
    gallery_valid = np.ones(128, bool)
    return params, frames, gallery, gallery_valid, generate_anchors(DET_SIZE)


def entry(device=None, compute_dtype: str = "bfloat16"):
    """-> (fn, example_args): the flagship forward and its arguments, all on
    ``device`` (the card unless named)."""
    device = resolve_device(device)
    fn = build_pipeline(device=device, compute_dtype=compute_dtype, **PIPELINE)
    params, frames, gallery, gallery_valid, priors = example_inputs()
    example_args = (
        {k: convert_params(v, device) for k, v in params.items()},
        torch.from_numpy(frames).to(device),
        torch.from_numpy(gallery).to(device),
        torch.from_numpy(gallery_valid).to(device),
        torch.from_numpy(priors.copy()).to(device),
    )
    return fn, example_args
