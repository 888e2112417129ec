"""WebSocket (RFC 6455) + Engine.IO v4 + Socket.IO v5 server.

The React dashboard connects with socket.io-client over a websocket-only
transport (reference ``frontend/src/api.js:128-167``), so this implements the
exact wire protocol that client speaks:

  HTTP GET /socket.io/?EIO=4&transport=websocket  + Upgrade: websocket
  -> ws frames carrying engine.io packets:
       '0{...}'  open (sid, ping interval/timeout)
       '2' / '3' ping / pong (server pings, client pongs)
       '4' + socket.io packet:
            '0' connect        -> reply '40{"sid":...}'
            '2["event",data]'  -> client emit
  server emits: '42["event",data]'

Events bridged from the platform EventHub: job_started / job_finished /
job_failed (reference async_task_manager.py:242-296) plus new_alert /
update_movement_log / update_tracking_feed — the three events the reference
frontend listens for but the reference backend never emits (SURVEY.md
section 5 observability note).
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import struct
import time
import uuid

from frp_tpu_torch.utils.logger import get_logger

logger = get_logger("frp.api.socketio")

WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
PING_INTERVAL_MS = 25000
PING_TIMEOUT_MS = 20000


# ---------------------------------------------------------------------------
# RFC 6455 framing
# ---------------------------------------------------------------------------

def accept_key(key: str) -> str:
    return base64.b64encode(hashlib.sha1((key + WS_MAGIC).encode()).digest()).decode()


def encode_frame(payload: bytes, opcode: int = 0x1) -> bytes:
    header = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        header += bytes([n])
    elif n < 65536:
        header += bytes([126]) + struct.pack(">H", n)
    else:
        header += bytes([127]) + struct.pack(">Q", n)
    return header + payload


MAX_WS_MESSAGE = 4 * 1024 * 1024  # reassembled-message cap


async def _read_raw_frame(reader: asyncio.StreamReader):
    """One wire frame -> (fin, opcode, payload) or None on EOF."""
    try:
        head = await reader.readexactly(2)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    fin_op, mask_len = head[0], head[1]
    fin = bool(fin_op & 0x80)
    opcode = fin_op & 0x0F
    masked = bool(mask_len & 0x80)
    length = mask_len & 0x7F
    if length == 126:
        length = struct.unpack(">H", await reader.readexactly(2))[0]
    elif length == 127:
        length = struct.unpack(">Q", await reader.readexactly(8))[0]
    if length > MAX_WS_MESSAGE:
        return None
    mask = await reader.readexactly(4) if masked else b"\x00" * 4
    data = bytearray(await reader.readexactly(length)) if length else bytearray()
    if masked:
        for i in range(len(data)):
            data[i] ^= mask[i % 4]
    return fin, opcode, bytes(data)


async def read_frame(reader: asyncio.StreamReader, on_control=None):
    """Returns one complete MESSAGE as (opcode, payload), reassembling
    fragmented data frames (RFC 6455 5.4: FIN=0 + continuation 0x0 frames —
    socket.io-client fragments payloads beyond its chunk size). Control
    frames (ping/pong/close) are never fragmented and may interleave
    mid-fragmentation: with ``on_control(opcode, payload)`` given they're
    handed to it and reassembly continues (close aborts); without it they're
    returned immediately (only safe outside fragmentation — test clients).
    Close (0x8) is returned to the caller for the RFC 5.5.1 echo.
    Returns None on EOF/overflow/protocol error."""
    first_opcode = None
    parts: list[bytes] = []
    total = 0
    while True:
        raw = await _read_raw_frame(reader)
        if raw is None:
            return None
        fin, opcode, payload = raw
        if opcode in (0x8, 0x9, 0xA):  # control: never fragmented
            if opcode == 0x8 or on_control is None:
                return opcode, payload
            on_control(opcode, payload)
            continue
        if opcode in (0x1, 0x2):
            if first_opcode is not None:
                return None  # new data frame before previous message's FIN
            first_opcode = opcode
            parts = [payload]
        elif opcode == 0x0:  # continuation
            if first_opcode is None:
                return None  # protocol error
            parts.append(payload)
        else:
            return None  # reserved opcode
        total += len(payload)
        if total > MAX_WS_MESSAGE:
            return None
        if fin:
            return first_opcode, b"".join(parts)


# ---------------------------------------------------------------------------
# Socket.IO server
# ---------------------------------------------------------------------------

class SocketIOServer:
    def __init__(self, event_hub=None, path: str = "/socket.io/"):
        self.path = path
        self._clients: dict[str, asyncio.Queue] = {}
        self._lock = asyncio.Lock()
        self._loop: asyncio.AbstractEventLoop | None = None
        self.connections_total = 0
        if event_hub is not None:
            event_hub.subscribe(self._on_platform_event)

    # thread-safe bridge from platform threads into the asyncio loop
    def _on_platform_event(self, event: str, data):
        loop = self._loop
        if loop is None or loop.is_closed():
            return
        loop.call_soon_threadsafe(self._broadcast_nowait, event, data)

    def _broadcast_nowait(self, event: str, data):
        packet = "42" + json.dumps([event, data], default=str)
        for q in list(self._clients.values()):
            q.put_nowait(packet)

    async def emit(self, event: str, data):
        self._broadcast_nowait(event, data)

    @property
    def client_count(self) -> int:
        return len(self._clients)

    # ------------------------------------------------------------------
    async def handle_upgrade(self, request, reader, writer):
        """Entry from HTTPServer on Upgrade: websocket."""
        self._loop = asyncio.get_running_loop()
        # Validate the upgrade target BEFORE completing the handshake
        # (RFC 6455 §4.2.2: a failed opening handshake must be an HTTP error,
        # not a 101 followed by a hangup).
        if not request.path.startswith(self.path.rstrip("/")):
            body = b'{"detail": "Not Found"}'
            writer.write(
                (
                    "HTTP/1.1 404 Not Found\r\n"
                    "Content-Type: application/json\r\n"
                    f"Content-Length: {len(body)}\r\n"
                    "Connection: close\r\n\r\n"
                ).encode()
                + body
            )
            await writer.drain()
            writer.close()
            return
        key = request.headers.get("sec-websocket-key", "")
        resp = (
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {accept_key(key)}\r\n\r\n"
        )
        writer.write(resp.encode())
        await writer.drain()

        sid = uuid.uuid4().hex
        open_packet = "0" + json.dumps(
            {
                "sid": sid,
                "upgrades": [],
                "pingInterval": PING_INTERVAL_MS,
                "pingTimeout": PING_TIMEOUT_MS,
                "maxPayload": 1000000,
            }
        )
        writer.write(encode_frame(open_packet.encode()))
        await writer.drain()

        queue: asyncio.Queue = asyncio.Queue()
        async with self._lock:
            self._clients[sid] = queue
            self.connections_total += 1
        logger.info("socket.io client connected: %s", sid)

        state = {"last_heard": time.monotonic()}
        sender = asyncio.create_task(self._send_loop(writer, queue))
        pinger = asyncio.create_task(self._ping_loop(queue, state, writer))
        try:
            await self._recv_loop(reader, queue, sid, state)
        finally:
            sender.cancel()
            pinger.cancel()
            # await the cancelled tasks: cancel() alone leaves them pending,
            # and a loop shutting down right after (connection-teardown
            # tests) garbage-collects the un-run coroutines with
            # "coroutine ignored" unraisable warnings
            for task in (sender, pinger):
                try:
                    await task
                except asyncio.CancelledError:
                    if not task.cancelled():
                        raise  # WE were cancelled while awaiting, propagate
                except Exception:
                    # a genuine sender/pinger crash must stay visible (it
                    # was previously surfaced by the task-exception logger)
                    logger.exception("socket.io %s task crashed",
                                     "send" if task is sender else "ping")
            async with self._lock:
                self._clients.pop(sid, None)
            logger.info("socket.io client disconnected: %s", sid)

    async def _send_loop(self, writer, queue: asyncio.Queue):
        try:
            while True:
                packet = await queue.get()
                if isinstance(packet, bytes):
                    # pre-encoded raw frame (e.g. a WS-level pong)
                    writer.write(packet)
                else:
                    writer.write(encode_frame(packet.encode()))
                await writer.drain()
        except (asyncio.CancelledError, ConnectionResetError, BrokenPipeError):
            pass

    async def _ping_loop(self, queue: asyncio.Queue, state: dict, writer):
        """Engine.IO heartbeat + liveness: a client that stops answering
        pings for pingInterval+pingTimeout is disconnected (Engine.IO v4
        heartbeat semantics; round 1 kept dead sockets forever)."""
        try:
            while True:
                await asyncio.sleep(PING_INTERVAL_MS / 1000)
                silent = time.monotonic() - state["last_heard"]
                if silent > (PING_INTERVAL_MS + PING_TIMEOUT_MS) / 1000:
                    logger.info("socket.io client timed out (%.0fs silent)", silent)
                    writer.close()
                    return
                queue.put_nowait("2")  # engine.io ping
        except asyncio.CancelledError:
            pass

    async def _recv_loop(self, reader, queue: asyncio.Queue, sid: str, state: dict):
        pending_binary: dict | None = None  # socket.io BINARY_EVENT reassembly

        def on_control(opcode, payload):
            state["last_heard"] = time.monotonic()
            if opcode == 0x9:  # ws ping -> ws pong (RFC 6455 5.5.3:
                # pong must carry the ping's application data verbatim)
                queue.put_nowait(encode_frame(payload, opcode=0xA))

        while True:
            frame = await read_frame(reader, on_control=on_control)
            if frame is None:
                return
            opcode, payload = frame
            state["last_heard"] = time.monotonic()
            if opcode == 0x8:  # close -> echo close (RFC 6455 5.5.1), done
                queue.put_nowait(encode_frame(payload[:2], opcode=0x8))
                await asyncio.sleep(0)  # let the sender flush
                return
            if opcode in (0x9, 0xA):  # control outside fragmentation
                on_control(opcode, payload)
                continue
            if opcode == 0x2:  # binary attachment for a pending BINARY_EVENT
                if pending_binary is not None:
                    pending_binary["buffers"].append(payload)
                    if len(pending_binary["buffers"]) >= pending_binary["count"]:
                        self._deliver_binary_event(pending_binary)
                        pending_binary = None
                continue
            text = payload.decode("utf-8", "replace")
            if not text:
                continue
            eio_type = text[0]
            if eio_type == "3":  # engine.io pong
                continue
            if eio_type == "2":  # engine.io ping (client-initiated, older)
                queue.put_nowait("3")
                continue
            if eio_type == "4":  # socket.io packet
                sio = text[1:]
                if sio.startswith("0"):  # connect -> ack
                    queue.put_nowait("40" + json.dumps({"sid": sid}))
                elif sio.startswith("2"):  # event from client
                    try:
                        event, *args = json.loads(sio[1:])
                        logger.debug("client event %s: %s", event, args)
                    except (json.JSONDecodeError, ValueError):
                        pass
                elif sio.startswith("5"):  # BINARY_EVENT: "5<n>-<json>"
                    try:
                        head, body = sio[1:].split("-", 1)
                        pending_binary = {
                            "count": int(head),
                            "body": body,
                            "buffers": [],
                        }
                        if pending_binary["count"] == 0:
                            self._deliver_binary_event(pending_binary)
                            pending_binary = None
                    except (ValueError, IndexError):
                        pending_binary = None
                elif sio.startswith("1"):  # disconnect
                    return

    def _deliver_binary_event(self, pending: dict):
        """Substitute {_placeholder: true, num: i} entries with the received
        binary buffers (socket.io protocol v5 binary events) and log it —
        the platform has no binary-consuming handlers, but the wire exchange
        must not desync the session."""
        try:
            decoded = json.loads(pending["body"])

            def subst(node):
                if isinstance(node, dict):
                    if node.get("_placeholder") and "num" in node:
                        i = int(node["num"])
                        bufs = pending["buffers"]
                        return bufs[i] if i < len(bufs) else None
                    return {k: subst(v) for k, v in node.items()}
                if isinstance(node, list):
                    return [subst(v) for v in node]
                return node

            event, *args = subst(decoded)
            sizes = [len(a) if isinstance(a, bytes) else a for a in args]
            logger.debug("client binary event %s: %s", event, sizes)
        except (json.JSONDecodeError, ValueError, TypeError):
            pass
