"""App assembly of the port: build the context, mount the routes, run the
server (port of ``frp_tpu/api/main.py``).

    python -m frp_tpu_torch.api.main [--device cuda|cpu] [--port 8000]
        [--scan-interval S] [--no-warmup] [--mesh auto|off]

The engine runs on the card unless ``--device cpu`` is given; without a
card the default raises. ``build_app`` mounts the JAX app's route table:
the root, status and debug routes and the camera, face, federated,
deepfake, alerts, snapshot, async-task, dashboard and frontend routes, in
the JAX order. ``--mesh auto`` (or ``FRP_MESH=auto``) brings up
``torch.distributed`` from the environment when one is configured and, with
more than one local card, serves over a mesh of them: the engine splits
every batch over the cards in nearly equal row shards (any size, the
warmup's B=1 included) and the FL combine runs over them
(``frp_tpu/api/main.py:207-230``).

One difference from the JAX server: a failed warmup raises. On the card
the first warmup is where nvcc builds the kernels, and a server that went
on serving after that failed would fail every scan.
"""

from __future__ import annotations

import asyncio
import os

import torch

from frp_tpu_torch.api.http import HTTPServer, Request, Router, json_response
from frp_tpu_torch.api.routes import (
    alerts as alerts_routes,
    async_tasks as async_routes,
    camera as camera_routes,
    dashboard as dashboard_routes,
    deepfake as deepfake_routes,
    face as face_routes,
    federated as federated_routes,
    frontend as frontend_routes,
    snapshot as snapshot_routes,
)
from frp_tpu_torch.api.socketio import SocketIOServer
from frp_tpu_torch.platform.context import AppContext
from frp_tpu_torch.platform.state import memory_info
from frp_tpu_torch.utils.logger import get_logger

logger = get_logger("frp.api.main")


def build_app(ctx: AppContext | None = None, **ctx_kwargs):
    """Returns (router, sio, ctx) with every route registered."""
    ctx = ctx or AppContext(**ctx_kwargs)
    router = Router()
    sio = SocketIOServer(event_hub=ctx.events)

    @router.get("/")
    async def root(request: Request):
        return json_response(
            {
                "message": "FastAPI backend is running",  # reference main.py:105
                "service": "face-recognition-platform (PyTorch/CUDA port)",
                "status": "running",
                "device": str(getattr(ctx.engine, "device", "")),
                "gallery_size": len(ctx.engine.gallery),
                "cameras": len(ctx.cameras.ids()),
                "storage_backend": ctx.db_backend,
                "socketio_clients": sio.client_count,
            }
        )

    @router.get("/camera/status")
    async def camera_status(request: Request):
        """Reference main.py:103-124 status endpoint."""
        cams = ctx.cameras.all()
        return json_response(
            {
                # the reference envelope the React app consumes
                # (main.py:108-124, App.jsx:67/214-222: entry.state === "ok"):
                "status": {
                    str(c.id): {
                        "state": "ok" if c.healthy else "error",
                        "name": c.name,
                        "geo": list(c.geo) if c.geo else None,
                    }
                    for c in cams
                },
                # extensions
                "total": len(cams),
                "active": [c.id for c in cams if c.healthy],
                "cameras": {str(c.id): c.info() for c in cams},
                "memory": memory_info(),
            }
        )

    @router.post("/debug/trace/start")
    async def trace_start(request: Request):
        label = request.query.get("label", "trace")
        return json_response(ctx.tracer.start(label))

    @router.post("/debug/trace/stop")
    async def trace_stop(request: Request):
        return json_response(ctx.tracer.stop())

    @router.get("/debug/timers")
    async def timers(request: Request):
        return json_response(
            {"stages": ctx.timers.summary(), "engine": ctx.engine.metrics.as_dict()}
        )

    @router.get("/debug/delta")
    async def delta_stats(request: Request):
        """Temporal-delta transfer health: keyframe/delta/desync counters so
        an operator can see encoder/engine desync (stale reconstructions are
        otherwise invisible — the pipeline happily serves them)."""
        return json_response(
            dict(getattr(ctx.engine, "delta_stats",
                         {"keyframes": 0, "deltas": 0, "desyncs": 0}))
        )

    @router.get("/debug/memory")
    async def memory(request: Request):
        return json_response(memory_info())

    camera_routes.register(router, ctx)
    face_routes.register(router, ctx)
    federated_routes.register(router, ctx)
    deepfake_routes.register(router, ctx)
    alerts_routes.register(router, ctx)
    snapshot_routes.register(router, ctx)
    async_routes.register(router, ctx)  # mounted (reference forgets this)
    dashboard_routes.register(router, ctx)
    frontend_routes.register(router, ctx)
    return router, sio, ctx


async def serve(
    host: str = "0.0.0.0",
    port: int = 8000,
    ctx: AppContext | None = None,
    scan_interval: float | None = None,
    warmup: bool = True,
    ready=None,
    device=None,
    mesh=None,
):
    """Run the server until cancelled. ``ready``, when given, is called
    with the bound (host, port) once the server listens (port 0 picks a free
    one). ``device`` or ``mesh`` is the engine's when ``ctx`` is None."""
    router, sio, ctx = build_app(ctx, device=device, mesh=mesh)
    server = HTTPServer(router, ws_handler=sio.handle_upgrade,
                        allowed_origins=ctx.cfg.frontend_origins)
    ctx.startup()
    stop = asyncio.Event()
    tasks = []

    async def model_cleanup_loop():
        # reference main.py:206-222
        while not stop.is_set():
            await asyncio.sleep(ctx.cfg.model_idle_unload_seconds)
            unloaded = ctx.models.cleanup_idle_models()
            if unloaded:
                logger.info("unloaded idle models: %s", unloaded)

    async def scan_loop():
        interval = scan_interval or ctx.cfg.camera_scan_interval
        while not stop.is_set():
            try:
                await asyncio.to_thread(
                    ctx.run_scan, ctx.cfg.face_tolerance, ctx.cfg.frame_skip, 10
                )
            except Exception:
                logger.exception("scan loop iteration failed")
            await asyncio.sleep(interval)

    try:
        if warmup:
            # the two shape sets production uses: B=1 RGB (enrolment and
            # compare uploads) and the multi-camera I420 scan, run dry (no
            # tracking records, alerts, store writes or socket events). A
            # failure raises
            await asyncio.to_thread(ctx.engine.warmup, 1)
            await asyncio.to_thread(
                ctx.run_scan, ctx.cfg.face_tolerance, ctx.cfg.frame_skip, 10, True,
            )
            # the dry scan ran the raw keyframe; run the delta stage once at
            # each capacity rung too, before the first live delta meets it
            if getattr(ctx.cfg, "delta_transfer", False) and hasattr(
                ctx.engine, "precompile_delta_rungs"
            ):
                rungs = await asyncio.to_thread(ctx.engine.precompile_delta_rungs)
                logger.info("delta-transfer rungs precompiled: %d", rungs)

        tasks.append(asyncio.create_task(model_cleanup_loop()))
        if scan_interval is not None:
            tasks.append(asyncio.create_task(scan_loop()))
        listening = await server.start(host, port)
        bound = listening.sockets[0].getsockname()[:2]
        logger.info("platform ready on %s:%d (device=%s, storage=%s)", bound[0], bound[1],
                    getattr(ctx.engine, "device", "?"), ctx.db_backend)
        if ready is not None:
            ready(bound)
        await stop.wait()
    finally:
        for t in tasks:
            t.cancel()
        await server.stop()
        ctx.shutdown()


def serving_mesh(mode: str, device: str):
    """The mesh ``--mesh`` asks for: None for "off"; for "auto",
    torch.distributed comes up from the environment (a no-op alone) and,
    when this process has more than one local card, a mesh over them
    (``parallel.make_mesh``); one card, or the CPU, serves without one, as
    the JAX server does with one device."""
    if mode == "off":
        return None
    from frp_tpu_torch.parallel import distributed_initialize, make_mesh

    dev = torch.device(device)
    dist = distributed_initialize(device=dev)
    if dev.type != "cuda" or torch.cuda.device_count() <= 1:
        return None
    mesh = make_mesh()
    logger.info("serving over a %d-device mesh (distributed: %s)", mesh.devices.size, dist)
    return mesh


def parse_args(argv: list[str] | None = None):
    import argparse

    p = argparse.ArgumentParser(description="face recognition platform, PyTorch/CUDA port")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=int(os.getenv("PORT", 8000)))
    p.add_argument(
        "--scan-interval",
        type=float,
        default=None,
        help="run the background multi-camera scan loop at this period (s)",
    )
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument(
        "--device",
        default="cuda",
        help="the engine's torch device: cuda (the default; raises without a "
        "card) or cpu",
    )
    p.add_argument(
        "--mesh",
        choices=["auto", "off"],
        default=os.getenv("FRP_MESH", "off"),
        help="auto: bring up torch.distributed (from FRP_COORDINATOR et al. or "
        "torchrun's variables; a no-op alone) and split the scan batch over "
        "every local card. Requires the camera count to be divisible by the "
        "card count.",
    )
    return p.parse_args(argv)


def main(argv: list[str] | None = None):
    args = parse_args(argv)
    mesh = serving_mesh(args.mesh, args.device)

    def ready(addr):
        print(f"serving on http://{addr[0]}:{addr[1]}", flush=True)

    asyncio.run(
        serve(
            args.host,
            args.port,
            scan_interval=args.scan_interval,
            warmup=not args.no_warmup,
            ready=ready,
            device=None if mesh is not None else args.device,
            mesh=mesh,
        )
    )


if __name__ == "__main__":
    main()
