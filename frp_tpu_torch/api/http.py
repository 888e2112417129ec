"""Minimal asyncio HTTP/1.1 server + router.

Replaces uvicorn + FastAPI for this platform's needs: path-param routing,
query strings, JSON bodies, multipart/form-data uploads (the enrollment
endpoint's file uploads, reference ``routes/face.py:114-165``), streaming
responses (the MJPEG camera feed, ``routes/camera.py:97-122``), keep-alive,
CORS, and WebSocket upgrade hand-off to the Socket.IO layer.
"""

from __future__ import annotations

import asyncio
import json
import re
import traceback
import urllib.parse
from typing import Any, AsyncIterator, Awaitable, Callable

from frp_tpu_torch.utils.logger import get_logger

logger = get_logger("frp.api.http")

MAX_BODY = 100 * 1024 * 1024  # hard cap; per-route limits are tighter


class HTTPError(Exception):
    def __init__(self, status: int, detail: str):
        self.status = status
        self.detail = detail
        super().__init__(detail)


class UploadFile:
    def __init__(self, filename: str, content_type: str, data: bytes):
        self.filename = filename
        self.content_type = content_type
        self.data = data

    @property
    def size(self) -> int:
        return len(self.data)


class Request:
    def __init__(self, method, path, query, headers, body, path_params=None):
        self.method = method
        self.path = path
        self.query: dict[str, str] = query
        self.headers: dict[str, str] = headers
        self.body = body
        self.path_params: dict[str, str] = path_params or {}

    def json(self) -> Any:
        if not self.body:
            return None
        try:
            return json.loads(self.body)
        except json.JSONDecodeError as e:
            raise HTTPError(400, f"invalid JSON body: {e}") from e

    def form(self) -> tuple[dict[str, str], dict[str, UploadFile]]:
        """Parse multipart/form-data or urlencoded bodies."""
        ctype = self.headers.get("content-type", "")
        if ctype.startswith("application/x-www-form-urlencoded"):
            fields = dict(urllib.parse.parse_qsl(self.body.decode("utf-8", "replace")))
            return fields, {}
        m = re.search(r'boundary="?([^";,]+)"?', ctype)
        if not m:
            raise HTTPError(400, "missing multipart boundary")
        boundary = b"--" + m.group(1).encode()
        fields: dict[str, str] = {}
        files: dict[str, UploadFile] = {}
        for part in self.body.split(boundary):
            # remove exactly ONE delimiter CRLF on each side — strip(b"\\r\\n")
            # removes EVERY trailing 0x0D/0x0A byte, silently truncating
            # binary uploads whose content ends in newline bytes
            if part.startswith(b"\r\n"):
                part = part[2:]
            if part.endswith(b"\r\n"):
                part = part[:-2]
            if not part or part == b"--":
                continue
            if b"\r\n\r\n" not in part:
                continue
            raw_headers, data = part.split(b"\r\n\r\n", 1)
            headers = {}
            for line in raw_headers.decode("utf-8", "replace").split("\r\n"):
                if ":" in line:
                    k, v = line.split(":", 1)
                    headers[k.strip().lower()] = v.strip()
            disp = headers.get("content-disposition", "")
            name_m = re.search(r'name="([^"]*)"', disp)
            file_m = re.search(r'filename="([^"]*)"', disp)
            if not name_m:
                continue
            name = name_m.group(1)
            if file_m:
                files[name] = UploadFile(
                    file_m.group(1),
                    headers.get("content-type", "application/octet-stream"),
                    data,
                )
            else:
                fields[name] = data.decode("utf-8", "replace")
        return fields, files

    def query_int(self, name: str, default: int) -> int:
        try:
            return int(self.query.get(name, default))
        except (TypeError, ValueError):
            raise HTTPError(422, f"query param '{name}' must be an integer")

    def query_float(self, name: str, default: float) -> float:
        try:
            return float(self.query.get(name, default))
        except (TypeError, ValueError):
            raise HTTPError(422, f"query param '{name}' must be a number")

    def query_bool(self, name: str, default: bool = False) -> bool:
        raw = self.query.get(name)
        if raw is None:
            return default
        return raw.strip().lower() in ("1", "true", "yes", "on")


class Response:
    def __init__(
        self,
        body: bytes = b"",
        status: int = 200,
        content_type: str = "application/json",
        headers: dict | None = None,
    ):
        self.body = body
        self.status = status
        self.content_type = content_type
        self.headers = headers or {}


class StreamResponse:
    """Chunked streaming response (MJPEG / CSV export)."""

    def __init__(
        self,
        gen: AsyncIterator[bytes],
        content_type: str,
        status: int = 200,
        headers: dict | None = None,
    ):
        self.gen = gen
        self.content_type = content_type
        self.status = status
        self.headers = headers or {}


def parse_float_param(raw, name: str, default: float) -> float:
    """422 (not 500) on malformed client-supplied numbers — FastAPI
    semantics, matching Request.query_float for form/mixed sources."""
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except (TypeError, ValueError):
        raise HTTPError(422, f"'{name}' must be a number")


def parse_int_param(raw, name: str, default: int) -> int:
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except (TypeError, ValueError):
        raise HTTPError(422, f"'{name}' must be an integer")


def json_response(data: Any, status: int = 200, headers: dict | None = None) -> Response:
    # The reference stamps "status": "success" on every 2xx JSON body
    # (grep JSONResponse across backend/app/routes/*) and its clients key off
    # it; inject it for any dict payload that doesn't set its own.
    if status < 300 and isinstance(data, dict) and "status" not in data:
        data = {"status": "success", **data}
    return Response(
        json.dumps(data, default=_json_default).encode(), status, "application/json", headers
    )


def _json_default(o):
    import numpy as np

    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, set):
        return sorted(o)
    return str(o)


_STATUS_TEXT = {
    200: "OK", 201: "Created", 204: "No Content", 304: "Not Modified",
    400: "Bad Request", 401: "Unauthorized", 404: "Not Found",
    405: "Method Not Allowed", 409: "Conflict", 413: "Payload Too Large",
    422: "Unprocessable Entity", 429: "Too Many Requests",
    431: "Request Header Fields Too Large",
    500: "Internal Server Error", 503: "Service Unavailable",
}


class Router:
    def __init__(self):
        self._routes: list[tuple[str, re.Pattern, list, Callable]] = []

    def add(self, method: str, pattern: str, handler: Callable[[Request], Awaitable]):
        names = re.findall(r"\{(\w+)\}", pattern)
        regex = re.compile(
            "^" + re.sub(r"\{\w+\}", r"([^/]+)", pattern.rstrip("/")) + "/?$"
        )
        self._routes.append((method.upper(), regex, names, handler))

    def get(self, pattern):
        return lambda fn: (self.add("GET", pattern, fn), fn)[1]

    def post(self, pattern):
        return lambda fn: (self.add("POST", pattern, fn), fn)[1]

    def patch(self, pattern):
        return lambda fn: (self.add("PATCH", pattern, fn), fn)[1]

    def delete(self, pattern):
        return lambda fn: (self.add("DELETE", pattern, fn), fn)[1]

    def resolve(self, method: str, path: str):
        # Prefer the most-literal match (fewest path params) so e.g.
        # POST /camera/bulk/restart wins over /camera/{cam_id}/restart
        # regardless of registration order; ties keep registration order.
        allowed = set()
        best = None
        for m, regex, names, handler in self._routes:
            match = regex.match(path)
            if match:
                if m == method:
                    if best is None or len(names) < len(best[1]):
                        best = (handler, names, match)
                else:
                    allowed.add(m)
        if best is not None:
            handler, names, match = best
            # percent-decode captures: FastAPI/Starlette route params arrive
            # decoded, and the reference frontend encodeURIComponent()s names
            # (api.js:249), so "wanted%20person" must bind as "wanted person"
            return handler, {
                n: urllib.parse.unquote(g) for n, g in zip(names, match.groups())
            }
        if allowed:
            raise HTTPError(405, f"method {method} not allowed (try {sorted(allowed)})")
        return None, None


class HTTPServer:
    def __init__(self, router: Router, ws_handler=None,
                 allowed_origins: str = "*"):
        self.router = router
        # FRONTEND_ORIGINS (reference main.py:44-59): "*" allows all;
        # otherwise a comma list — the response echoes the request Origin
        # only when allowlisted (plus Vary: Origin for caches)
        self.allowed_origins = [o.strip() for o in allowed_origins.split(",")
                                if o.strip()] or ["*"]
        self.ws_handler = ws_handler  # async def (request, reader, writer)
        self._server: asyncio.AbstractServer | None = None
        self._conn_tasks: set = set()  # live connection-handler tasks

    async def start(self, host: str = "0.0.0.0", port: int = 8000):
        self._server = await asyncio.start_server(self._handle_conn, host, port)
        logger.info("HTTP server listening on %s:%d", host, port)
        return self._server

    async def stop(self):
        if self._server is not None:
            self._server.close()
            # also end LIVE connections: close() only stops the listener
            # (3.12 has no Server.close_clients), and abandoned handler
            # tasks — websocket send loops park on queue.get forever —
            # turn into "coroutine ignored" unraisable warnings at loop
            # shutdown. Cancel and await until the set DRAINS: a handler
            # accepted in the same tick as stop() registers itself only on
            # its first step, so one cancellation sweep can miss it.
            for _ in range(8):
                tasks = list(self._conn_tasks)
                if not tasks:
                    break
                for task in tasks:
                    task.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
            await self._server.wait_closed()
            self._server = None

    # ------------------------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
            task.add_done_callback(self._conn_tasks.discard)
        try:
            while True:
                try:
                    request = await self._read_request(reader)
                except HTTPError as e:
                    # e.g. 413 from the body-size caps: answer properly
                    # instead of silently dropping the connection.
                    body = json.dumps({"detail": e.detail}).encode()
                    status_text = _STATUS_TEXT.get(e.status, "Error")
                    writer.write(
                        (
                            f"HTTP/1.1 {e.status} {status_text}\r\n"
                            "Content-Type: application/json\r\n"
                            f"Content-Length: {len(body)}\r\n"
                            "Connection: close\r\n\r\n"
                        ).encode()
                        + body
                    )
                    await writer.drain()
                    break
                if request is None:
                    break
                if (
                    self.ws_handler is not None
                    and request.headers.get("upgrade", "").lower() == "websocket"
                ):
                    await self.ws_handler(request, reader, writer)
                    return  # websocket owns the connection
                keep_alive = await self._dispatch(request, writer)
                if not keep_alive:
                    break
        except (ConnectionResetError, BrokenPipeError, asyncio.IncompleteReadError):
            pass
        except Exception:
            logger.exception("connection handler error")
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _read_request(self, reader) -> Request | None:
        try:
            line = await asyncio.wait_for(reader.readline(), timeout=75)
        except asyncio.TimeoutError:
            return None
        except ValueError:  # request line beyond the StreamReader limit
            raise HTTPError(431, "request line too long")
        if not line or line in (b"\r\n", b"\n"):
            return None
        try:
            method, target, _version = line.decode("latin1").strip().split(" ", 2)
        except ValueError:
            return None
        headers: dict[str, str] = {}
        # cap the header section (MAX_BODY only bounds the body) and keep
        # the 75 s deadline running through it — otherwise an endless or
        # byte-per-minute header stream grows memory / pins the connection
        deadline = asyncio.get_running_loop().time() + 75
        header_bytes = 0
        while True:
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                return None
            try:
                hline = await asyncio.wait_for(reader.readline(), timeout=remaining)
            except asyncio.TimeoutError:
                return None
            except ValueError:
                # a single header line beyond the StreamReader limit (64 KB)
                raise HTTPError(431, "header line too long")
            if not hline or hline in (b"\r\n", b"\n"):
                break
            header_bytes += len(hline)
            if header_bytes > 65536 or len(headers) > 200:
                raise HTTPError(431, "header section too large")
            if b":" in hline:
                k, v = hline.decode("latin1").split(":", 1)
                headers[k.strip().lower()] = v.strip()
        body = b""
        try:
            length = int(headers.get("content-length", 0) or 0)
        except ValueError:
            raise HTTPError(400, "invalid Content-Length")
        if length < 0:
            raise HTTPError(400, "invalid Content-Length")
        if length:
            if length > MAX_BODY:
                raise HTTPError(413, "body too large")
            body = await reader.readexactly(length)
        elif headers.get("transfer-encoding", "").lower() == "chunked":
            chunks = []
            total = 0
            while True:
                size_line = await reader.readline()
                try:
                    # chunk extensions ("1a;ext=1") are legal; size is the
                    # part before ';'
                    size = int(
                        (size_line.split(b";")[0].strip() or b"0"), 16
                    )
                except ValueError:
                    raise HTTPError(400, "invalid chunk size")
                if size == 0:
                    await reader.readline()
                    break
                total += size
                if total > MAX_BODY:
                    # A chunked body has no Content-Length to pre-check, so
                    # the cap must be enforced cumulatively mid-stream.
                    raise HTTPError(413, "body too large")
                chunks.append(await reader.readexactly(size))
                await reader.readline()
            body = b"".join(chunks)
        parsed = urllib.parse.urlsplit(target)
        query = dict(urllib.parse.parse_qsl(parsed.query))
        return Request(method.upper(), parsed.path, query, headers, body)

    async def _dispatch(self, request: Request, writer) -> bool:
        try:
            if request.method == "OPTIONS":  # CORS preflight
                response = Response(b"", 204)
            else:
                handler, params = self.router.resolve(request.method, request.path)
                if handler is None:
                    response = json_response({"detail": "Not Found"}, 404)
                else:
                    request.path_params = params
                    response = await handler(request)
                    if not isinstance(response, (Response, StreamResponse)):
                        response = json_response(response)
        except HTTPError as e:
            response = json_response({"detail": e.detail}, e.status)
        except Exception as e:
            # document-schema violations surface as 422s (FastAPI semantics;
            # the pydantic models are wired at the store boundary,
            # platform/schemas.py + platform/dbops.py)
            if type(e).__name__ == "ValidationError":
                response = json_response({"detail": str(e)}, 422)
            else:
                logger.error("handler error: %s", traceback.format_exc())
                response = json_response({"detail": "Internal Server Error"}, 500)

        if "*" in self.allowed_origins:
            allow_origin = "*"
        else:
            origin = request.headers.get("origin", "")
            allow_origin = origin if origin in self.allowed_origins else ""
        cors = {
            "Access-Control-Allow-Origin": allow_origin,
            "Access-Control-Allow-Methods": "GET, POST, PATCH, DELETE, OPTIONS",
            "Access-Control-Allow-Headers": "*",
        }
        if "*" not in self.allowed_origins:
            # allowlist mode varies the response by Origin — including
            # denials, or a shared cache could serve the ACAO-less variant
            # to an allowlisted origin
            cors["Vary"] = "Origin"
        if not allow_origin:
            cors.pop("Access-Control-Allow-Origin")
        status_text = _STATUS_TEXT.get(response.status, "OK")
        if isinstance(response, StreamResponse):
            head = [f"HTTP/1.1 {response.status} {status_text}"]
            head.append(f"Content-Type: {response.content_type}")
            head.append("Connection: close")
            for k, v in {**cors, **response.headers}.items():
                head.append(f"{k}: {v}")
            writer.write(("\r\n".join(head) + "\r\n\r\n").encode())
            await writer.drain()
            try:
                async for chunk in response.gen:
                    writer.write(chunk)
                    await writer.drain()
            except (ConnectionResetError, BrokenPipeError):
                pass
            return False  # streamed connections close when done

        head = [f"HTTP/1.1 {response.status} {status_text}"]
        head.append(f"Content-Type: {response.content_type}")
        head.append(f"Content-Length: {len(response.body)}")
        head.append("Connection: keep-alive")
        for k, v in {**cors, **response.headers}.items():
            head.append(f"{k}: {v}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + response.body)
        await writer.drain()
        return True
