"""Federated-learning routes (port of ``frp_tpu/api/routes/federated.py``) —
reference ``backend/app/routes/federated.py`` contract (17 endpoints under
/face/fl), backed by the FederatedService (the host FedAvg combine).
"""

from __future__ import annotations

import asyncio
from datetime import datetime

import numpy as np

from frp_tpu_torch.api.http import parse_int_param, HTTPError, Request, StreamResponse, json_response
from frp_tpu_torch.ops.fedavg import FedAvgError


def _weights_to_json(weights: dict) -> dict:
    return {k: np.asarray(v).tolist() for k, v in weights.items()}


def _client_status_payload(fl, client_id: str) -> dict:
    """Per-client status with the reference's response shape
    (federated.py:271-346): weights + layers + client_info + metrics.
    A missing client is NOT a 404 there — it returns success with a hint."""
    w = fl.get_weights(client_id)
    if w is None:
        return {
            "status": "success",
            "client_id": client_id,
            "weights": {},
            "message": "No weights found for this client",
            "suggestion": "Client needs to upload weights first",
        }
    info = next(
        (c for c in fl.list_clients() if c.get("client_id") == client_id), {}
    )
    metrics = fl.get_client_metrics(client_id)
    top = fl.status()
    return {
        "status": "success",
        "client_id": client_id,
        "weights": _weights_to_json(w),
        "layers": sorted(w.keys()),
        "client_info": {
            "last_update": info.get("last_upload"),
            "round": top["round"],
            "contribution_count": info.get("contribution_count", 0),
            "status": "active" if client_id in top["active_clients"] else "inactive",
        },
        "metrics": {
            "total_updates": metrics.get("uploads", 0),
            "rounds_participated": metrics.get("uploads", 0),
        },
        "global_model_version": top["version"],
    }


def register(router, ctx):
    fl = ctx.federated

    @router.post("/face/fl/upload_weights")
    async def upload_weights(request: Request):
        body = request.json() or {}
        # The reference's pydantic field is 'target' (federated.py:63-64) and
        # the frontend posts {target, weights} (api.js:220-227); accept both.
        client_id = body.get("target") or body.get("client_id")
        weights = body.get("weights")
        if not client_id or not isinstance(weights, dict):
            raise HTTPError(422, "'target' and 'weights' (dict of layers) required")
        try:
            result = await asyncio.to_thread(fl.upload_weights, client_id, weights)
        except FedAvgError as e:
            raise HTTPError(400, str(e))
        top = fl.status()
        # reference envelope (federated.py:248-258): App.jsx:291 keys off
        # status === "success"
        return json_response(
            {
                "status": "success",
                "message": f"Federated weights received for client '{client_id}'",
                "client_id": client_id,
                "round": result["round"],
                "layers": result["layers"],
                "total_parameters": result["total_params"],
                "contribution_count": next(
                    (
                        c.get("contribution_count", 0)
                        for c in fl.list_clients()
                        if c.get("client_id") == client_id
                    ),
                    0,
                ),
                "global_model_version": top["version"],
                "timestamp": datetime.now().isoformat(),
                **result,  # extensions: success/warning/total_params
            }
        )

    @router.post("/face/fl/aggregate")
    async def aggregate(request: Request):
        body = request.json() or {}
        # Reference AggregationConfig (federated.py:83-88): client_selection
        # + weights_strategy equal|contribution; our names kept as extensions.
        client_ids = body.get("client_ids") or body.get("client_selection")
        proportional = bool(body.get("proportional", False)) or (
            body.get("weights_strategy") == "contribution"
        )
        try:
            result = await asyncio.to_thread(
                fl.aggregate,
                client_ids,
                proportional,
                body.get("min_clients"),
            )
        except FedAvgError as e:
            raise HTTPError(400, str(e))
        gm = fl.get_weights(result["global_model"])
        # reference envelope (federated.py:672-690); new_model_version /
        # model_version are additive so App.jsx:327/574 renders a number
        # instead of the reference's literal `undefined`
        return json_response(
            {
                "status": "success",
                "message": "Model aggregation completed successfully",
                "global_model": {
                    "id": result["global_model"],
                    "version": result["version"],
                    "round": result["round"],
                    "layers": sorted(gm.keys()) if gm else result.get("layer_count"),
                    "total_parameters": int(
                        sum(np.asarray(w).size for w in (gm or {}).values())
                    ),
                },
                "aggregation_details": {
                    "clients_aggregated": len(result["clients"]),
                    "client_ids": result["clients"],
                    "algorithm": "fedavg",
                    "weights_strategy": "contribution" if proportional else "equal",
                    "aggregation_weights": result["weights"],
                },
                "timestamp": result["timestamp"],
                "new_model_version": result["version"],
                "model_version": result["version"],
                # extensions: success/round/version/clients/backend/...
                **{k: v for k, v in result.items() if k != "global_model"},
                "global_model_id": result["global_model"],
            }
        )

    @router.get("/face/fl/status")
    async def status(request: Request):
        # Reference /status requires client_id and returns that client's
        # stored weights (federated.py:271-346); the no-param variant is our
        # extension returning the whole-system summary.
        client_id = request.query.get("client_id")
        if client_id:
            return json_response(_client_status_payload(fl, client_id))
        return json_response(fl.status())

    @router.get("/face/fl/get_weights")
    async def get_weights(request: Request):
        # Reference: GET /get_weights?target=X == /status?client_id=X
        # (federated.py:352-354; frontend api.js:218 passes 'target').
        name = (
            request.query.get("target")
            or request.query.get("client_id")
            or request.query.get("name")
        )
        if not name:
            raise HTTPError(422, "'target' query parameter required")
        return json_response(_client_status_payload(fl, name))

    @router.delete("/face/fl/weights/{name}")
    async def delete_weights(request: Request):
        result = fl.delete_weights(request.path_params["name"])
        if not result["success"]:
            raise HTTPError(404, "weights not found")
        return json_response(result)

    async def _list_clients(request: Request):
        return json_response({"clients": fl.list_clients()})

    # Reference path is /face/fl/list (federated.py:417); /clients kept too.
    router.get("/face/fl/list")(_list_clients)
    router.get("/face/fl/clients")(_list_clients)

    async def _register_client(request: Request):
        body = request.json() or {}
        client_id = body.get("client_id")
        if not client_id:
            raise HTTPError(422, "'client_id' required")
        # Reference ClientConfig carries client_name/metadata (federated.py:90-93).
        info = body.get("info") or {}
        if body.get("client_name"):
            info["client_name"] = body["client_name"]
        if body.get("metadata"):
            info["metadata"] = body["metadata"]
        return json_response(fl.register_client(client_id, info or None))

    # Reference path is /face/fl/register (federated.py:489).
    router.post("/face/fl/register")(_register_client)
    router.post("/face/fl/clients/register")(_register_client)

    async def _unregister_client(request: Request):
        result = fl.unregister_client(request.path_params["client_id"])
        if not result["success"]:
            raise HTTPError(404, "client not found")
        return json_response(result)

    # Reference path is DELETE /face/fl/unregister/{client_id} (federated.py:534).
    router.delete("/face/fl/unregister/{client_id}")(_unregister_client)
    router.delete("/face/fl/clients/{client_id}")(_unregister_client)

    @router.get("/face/fl/global_model")
    async def global_model(request: Request):
        version = parse_int_param(
            request.query.get("version"), "version", 0
        ) or None
        got = fl.get_global_model(version)
        if got is None:
            # reference federated.py:714-720: success-with-suggestion, not 404
            return json_response(
                {
                    "status": "success",
                    "message": "No global model available yet",
                    "global_model_version": 0,
                    "model_version": 0,
                    "suggestion": "Aggregate client weights first using /aggregate endpoint",
                }
            )
        name, weights = got
        v = int(name.split("v")[-1])
        return json_response(
            {"status": "success", "name": name, "version": v,
             "model_version": v, "global_model_version": v,
             "weights": _weights_to_json(weights)}
        )

    async def _history(request: Request):
        return json_response({"history": fl.get_history()})

    # Reference path is /face/fl/aggregation/history (federated.py:775).
    router.get("/face/fl/aggregation/history")(_history)
    router.get("/face/fl/history")(_history)

    @router.get("/face/fl/stats")
    async def stats(request: Request):
        return json_response(fl.get_stats())

    async def _client_metrics(request: Request):
        m = fl.get_client_metrics(request.path_params["client_id"])
        if not m:
            raise HTTPError(404, "no metrics for client")
        return json_response(m)

    # Reference path is /face/fl/client/{id}/metrics (federated.py:880).
    router.get("/face/fl/client/{client_id}/metrics")(_client_metrics)
    router.get("/face/fl/clients/{client_id}/metrics")(_client_metrics)

    @router.post("/face/fl/reset")
    async def reset(request: Request):
        body = request.json() or {}
        if body.get("confirm") != "CONFIRM_RESET":  # federated.py:925-980
            raise HTTPError(400, "pass confirm=CONFIRM_RESET to reset FL state")
        return json_response(fl.reset())

    @router.get("/face/fl/export")
    async def export(request: Request):
        fmt = request.query.get("format", "json")
        data = fl.export()
        if fmt == "csv":
            async def gen():
                yield b"round,version,clients,timestamp\n"
                for h in data["history"]:
                    yield (
                        f"{h['round']},{h['version']},"
                        f"\"{';'.join(h['clients'])}\",{h['timestamp']}\n"
                    ).encode()

            return StreamResponse(gen(), "text/csv")
        return json_response(data)

    @router.get("/face/fl/health")
    async def health(request: Request):
        return json_response(fl.health_check())

    @router.post("/face/fl/round/start")
    async def round_start(request: Request):
        return json_response(fl.start_round())

    @router.get("/face/fl/round/status")
    async def round_status(request: Request):
        return json_response(fl.round_status())

    @router.post("/face/fl/validate")
    async def validate(request: Request):
        body = request.json() or {}
        weights = body.get("weights")
        if not isinstance(weights, dict):
            raise HTTPError(422, "'weights' dict required")
        return json_response(fl.validate_weights(weights))
