"""Mock camera worker: POSTs synthetic frames to the platform's ingest
endpoint on an interval. A copy of ``tools/mock_camera_worker.py`` (numpy,
cv2 or PIL, and urllib; no engine), aimed at either package's server:
POST /api/camera/ingest (``frp_tpu_torch/api/routes/camera.py``).

Usage: python -m frp_tpu_torch.tools.mock_camera_worker --url http://localhost:8000 \
           --camera-id 9 --interval 2
"""

from __future__ import annotations

import argparse
import io
import sys
import time
import urllib.request

import numpy as np


def encode_jpeg(frame: np.ndarray) -> bytes:
    try:
        import cv2

        ok, buf = cv2.imencode(".jpg", frame)
        if ok:
            return buf.tobytes()
    except ImportError:
        pass
    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(frame[..., ::-1]).save(b, "JPEG")
    return b.getvalue()


def post_frame(url: str, cam_id: int, jpeg: bytes) -> int:
    boundary = "mockworkerboundary"
    body = (
        f'--{boundary}\r\nContent-Disposition: form-data; name="camera_id"\r\n\r\n{cam_id}\r\n'
        f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
        f'filename="frame.jpg"\r\nContent-Type: image/jpeg\r\n\r\n'
    ).encode() + jpeg + f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        url.rstrip("/") + "/api/camera/ingest",
        data=body,
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--url", default="http://localhost:8000")
    p.add_argument("--camera-id", type=int, default=9)
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument("--count", type=int, default=0, help="0 = run forever")
    args = p.parse_args(argv)

    rng = np.random.default_rng(0)
    base = rng.integers(0, 120, size=(720, 1280, 3), dtype=np.uint8)
    sent = 0
    while args.count == 0 or sent < args.count:
        frame = base.copy()
        size = 180
        x = (sent * 37) % (1280 - size)
        y = (sent * 23) % (720 - size)
        frame[y : y + size, x : x + size] = 230
        try:
            status = post_frame(args.url, args.camera_id, encode_jpeg(frame))
            print(f"pushed frame {sent} -> {status}")
        except Exception as e:
            print(f"push failed: {e}", file=sys.stderr)
        sent += 1
        time.sleep(args.interval)


if __name__ == "__main__":
    main()
