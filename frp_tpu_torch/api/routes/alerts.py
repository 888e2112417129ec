"""Alert routes — reference ``backend/app/routes/alerts.py`` contract
(11 endpoints under /alerts) plus the runtime email/SMS reconfig endpoints
the reference frontend calls but the reference backend never implemented
(api.js:257-259 -> /alerts/config/email|sms; SURVEY.md "defects to fix").
"""

from __future__ import annotations

from datetime import datetime

from frp_tpu_torch.api.http import HTTPError, Request, StreamResponse, json_response

PRIORITY_ORDER = {"critical": 0, "high": 1, "medium": 2, "low": 3}


def register(router, ctx):
    alerts = ctx.alerts

    @router.get("/alerts/")
    async def list_alerts(request: Request):
        """Filter/paginate/sort (reference alerts.py:38-130)."""
        target = request.query.get("target")
        priority = request.query.get("priority")
        since = request.query.get("since")
        try:
            since_dt = datetime.fromisoformat(since) if since else None
        except ValueError:
            raise HTTPError(422, "'since' must be an ISO-8601 timestamp")
        limit = request.query_int("limit", 50)
        offset = request.query_int("offset", 0)
        sort = request.query.get("sort", "time")
        items = alerts.get_alerts(target, priority, since_dt)
        if sort == "priority":
            items.sort(key=lambda a: (PRIORITY_ORDER.get(a["priority"], 9), a["timestamp"]))
        total = len(items)
        items = items[offset : offset + limit]
        return json_response(
            {
                "status": "success",  # reference alerts.py:112-124 envelope
                "count": len(items),
                "total": total,
                "offset": offset,
                "limit": limit,
                "alerts": items,
                "filters": {"target": target, "priority": priority, "since": since},
            }
        )

    @router.get("/alerts/latest")
    async def latest(request: Request):
        alert = alerts.get_latest_alert(request.query.get("target"))
        if alert is None:  # reference alerts.py:144
            return json_response(
                {"status": "success", "alert": None, "message": "No alerts found"}
            )
        return json_response({"status": "success", "alert": alert})

    @router.get("/alerts/watchlist")
    async def get_watchlist(request: Request):
        wl = alerts.get_watchlist()
        # reference alerts.py:161 envelope
        return json_response(
            {"status": "success", "count": len(wl), "watchlist": sorted(wl)}
        )

    @router.post("/alerts/watchlist/{target}")
    async def add_watchlist_path(request: Request):
        """Reference contract: POST /alerts/watchlist/{target}
        (alerts.py:169; the frontend posts this form, api.js:249)."""
        target = request.path_params["target"]
        result = alerts.add_to_watchlist(target)
        # reference alerts.py:187 envelope
        return json_response(
            {"status": "success",
             "message": result.get("message", "Added to watchlist"),
             "target": target, **result}
        )

    @router.post("/alerts/watchlist")
    async def add_watchlist(request: Request):
        # JSON-body variant kept as an extension.
        body = request.json() or {}
        target = body.get("target")
        if not target:
            raise HTTPError(422, "'target' required")
        return json_response(alerts.add_to_watchlist(target))

    @router.delete("/alerts/watchlist/{target}")
    async def remove_watchlist(request: Request):
        target = request.path_params["target"]
        result = alerts.remove_from_watchlist(target)
        if not result["success"]:
            raise HTTPError(404, "target not on watchlist")
        # reference alerts.py:209 envelope
        return json_response(
            {"status": "success",
             "message": result.get("message", "Removed from watchlist"),
             "target": target, **result}
        )

    @router.get("/alerts/geofences")
    async def get_geofences(request: Request):
        gf = alerts.get_geofences()
        # reference alerts.py:227 envelope
        return json_response({"status": "success", "count": len(gf), "geofences": gf})

    @router.post("/alerts/geofences")
    async def add_geofence(request: Request):
        body = request.json() or {}
        name = body.get("name")
        cameras = body.get("cameras")
        if not name or not isinstance(cameras, list):
            raise HTTPError(422, "'name' and 'cameras' (list) required")
        return json_response(
            alerts.add_geofence(name, cameras, body.get("description", ""))
        )

    @router.delete("/alerts/geofences/{name}")
    async def remove_geofence(request: Request):
        result = alerts.remove_geofence(request.path_params["name"])
        if not result["success"]:
            raise HTTPError(404, "geofence not found")
        return json_response(result)

    @router.get("/alerts/stats")
    async def stats(request: Request):
        return json_response(alerts.get_statistics())

    @router.post("/alerts/acknowledge")
    async def acknowledge(request: Request):
        body = request.json() or {}
        alert_id = body.get("alert_id")
        if not alert_id:
            raise HTTPError(422, "'alert_id' required")
        result = alerts.acknowledge_alert(
            alert_id, body.get("acknowledged_by", "operator"), body.get("notes")
        )
        if not result["success"]:
            raise HTTPError(404, result["message"])
        return json_response(result)

    @router.get("/alerts/export")
    async def export(request: Request):
        fmt = request.query.get("format", "json")
        items = alerts.get_alerts()
        if fmt == "csv":
            async def gen():
                yield b"alert_id,target,camera_id,priority,distance,timestamp\n"
                for a in items:
                    yield (
                        f"{a['alert_id']},{a['target']},{a['camera_id']},"
                        f"{a['priority']},{a['distance']},{a['timestamp']}\n"
                    ).encode()

            return StreamResponse(gen(), "text/csv")
        return json_response({"count": len(items), "alerts": items})

    @router.get("/alerts/ping")
    async def ping(request: Request):
        return json_response({"status": "ok", "service": "alerts"})

    # implemented here although absent in the reference backend: the frontend
    # calls these wrappers (api.js:257-259)
    @router.post("/alerts/config/email")
    async def config_email(request: Request):
        return json_response(alerts.configure_email(**(request.json() or {})))

    @router.post("/alerts/config/sms")
    async def config_sms(request: Request):
        return json_response(alerts.configure_sms(**(request.json() or {})))
