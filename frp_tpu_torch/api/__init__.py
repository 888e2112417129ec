"""The port's HTTP + Socket.IO edge (a copy of ``frp_tpu/api``'s pure-asyncio
server, routes and Socket.IO implementation, serving the port's engine)."""
