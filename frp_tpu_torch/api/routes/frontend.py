"""Serve the rebuilt frontend (frontend/ at the repo root) at GET /app (port
of ``frp_tpu/api/routes/frontend.py``).

The reference ships a React/Vite app (frontend/src/App.jsx, api.js,
components/{FaceUpload,CameraGrid}.jsx) built against axios +
socket.io-client. Our rebuild is dependency-free ES modules — including a
from-scratch Socket.IO/Engine.IO browser client (frontend/src/sio.js) — so
the backend can serve it directly with no build step. The vanilla /dashboard
page remains as the minimal ops view.
"""

from __future__ import annotations

import os
import re

from frp_tpu_torch.api.http import Request, Response

_SAFE_NAME = re.compile(r"^[A-Za-z0-9_.-]+$")

_MIME = {
    ".html": "text/html; charset=utf-8",
    ".js": "text/javascript; charset=utf-8",
    ".css": "text/css; charset=utf-8",
    ".json": "application/json",
    ".svg": "image/svg+xml",
    ".png": "image/png",
    ".ico": "image/x-icon",
}


def frontend_dir() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(__file__)))),
        "frontend",
    )


def _serve(relpath: str) -> Response:
    parts = relpath.split("/")
    if any(not _SAFE_NAME.match(p) or p.startswith("..") for p in parts):
        return Response(b'{"detail": "not found"}', 404)
    path = os.path.join(frontend_dir(), *parts)
    if not os.path.isfile(path):
        return Response(b'{"detail": "not found"}', 404)
    with open(path, "rb") as f:
        data = f.read()
    ext = os.path.splitext(path)[1].lower()
    return Response(
        data,
        200,
        _MIME.get(ext, "application/octet-stream"),
        headers={"Cache-Control": "no-cache"},
    )


def register(router, ctx):
    @router.get("/app")
    async def app_index(request: Request):
        return _serve("index.html")

    @router.get("/app/{name}")
    async def app_file(request: Request):
        return _serve(request.path_params["name"])

    @router.get("/app/src/{name}")
    async def app_src_file(request: Request):
        return _serve("src/" + request.path_params["name"])
