"""Run the full platform for browser demos and frontend checks. Port of
``tools/demo_server.py``.

    python -m frp_tpu_torch.tools.demo_server --device cpu --port 8010 --scan-interval 2

Serves exactly what ``python -m frp_tpu_torch.api.main`` serves (every
route, the Socket.IO edge, the background scan loop over the synthetic
cameras), on 127.0.0.1:8010 with a 2 s scan by default. The engine runs on
the card unless ``--device cpu`` is given; the JAX tool pins its CPU backend
so that a demo does not hold the TPU.
"""

from __future__ import annotations

import argparse
import asyncio


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8010)
    p.add_argument("--scan-interval", type=float, default=2.0)
    p.add_argument("--no-scan", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from frp_tpu_torch.api.main import serve

    def ready(addr):
        print(f"serving on http://{addr[0]}:{addr[1]}", flush=True)

    asyncio.run(serve(args.host, args.port,
                      scan_interval=None if args.no_scan else args.scan_interval,
                      ready=ready, device=args.device))


if __name__ == "__main__":
    main()
