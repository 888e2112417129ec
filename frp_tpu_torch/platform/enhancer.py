"""Snapshot enhancer (port of ``frp_tpu/platform/enhancer.py``) — bicubic
upscale (capped 4 MP) + unsharp mask + JPEG re-encode, reference
``backend/app/services/enhancer.py:49-89`` semantics. Pillow when present,
cv2 fallback, no-op otherwise.
"""

from __future__ import annotations

import io

from frp_tpu_torch.utils.logger import get_logger

logger = get_logger("frp.platform.enhancer")

MAX_PIXELS = 4_000_000   # ENHANCER_MAX_PIXELS default
UPSCALE = 2              # ENHANCER_UPSCALE_FACTOR default
JPEG_QUALITY = 85        # ENHANCER_JPEG_QUALITY default


def enhance_snapshot_bytes(data: bytes, *, upscale: float = UPSCALE,
                           max_pixels: int = MAX_PIXELS,
                           sharpen: bool = True,
                           quality: int = JPEG_QUALITY) -> bytes | None:
    """Returns enhanced JPEG bytes, or None when no enhancement is possible.

    Keyword knobs = the reference's ENHANCER_* env vars
    (enhancer.py:49-89), threaded from Config by the snapshot route."""
    try:
        from PIL import Image, ImageFilter

        img = Image.open(io.BytesIO(data)).convert("RGB")
        w, h = img.size
        scale = upscale
        if w * h * scale * scale > max_pixels:
            scale = max(1.0, (max_pixels / (w * h)) ** 0.5)
        if scale > 1.0:
            img = img.resize(
                (int(w * scale), int(h * scale)), Image.Resampling.BICUBIC
            )
        if sharpen:
            img = img.filter(
                ImageFilter.UnsharpMask(radius=2, percent=120, threshold=2))
        buf = io.BytesIO()
        img.save(buf, "JPEG", quality=quality)
        return buf.getvalue()
    except ImportError:
        pass
    except Exception:
        logger.exception("PIL enhancement failed")
        return None
    try:
        import cv2
        import numpy as np

        arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if arr is None:
            return None
        h, w = arr.shape[:2]
        scale = (upscale if w * h * upscale * upscale <= max_pixels
                 else max(1.0, (max_pixels / (w * h)) ** 0.5))
        if scale > 1.0:
            arr = cv2.resize(arr, (int(w * scale), int(h * scale)), interpolation=cv2.INTER_CUBIC)
        if sharpen:
            blur = cv2.GaussianBlur(arr, (0, 0), 2)
            arr = cv2.addWeighted(arr, 1.0 + 1.2, blur, -1.2, 0)
        ok, buf = cv2.imencode(".jpg", arr, [cv2.IMWRITE_JPEG_QUALITY, int(quality)])
        return buf.tobytes() if ok else None
    except Exception:
        logger.exception("cv2 enhancement failed")
        return None
