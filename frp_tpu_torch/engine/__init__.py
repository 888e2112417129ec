"""The device-resident inference engine of the port: the staged
``RecognitionEngine``, the single-program ``build_pipeline`` and the
``DeviceGallery`` they match against."""

from frp_tpu_torch.engine.gallery import DeviceGallery
from frp_tpu_torch.engine.pipeline import (
    RecognitionEngine,
    build_pipeline,
    embed_compact_rungs,
)
