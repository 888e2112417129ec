"""Alert service: watchlist, geofences, priority matrix, notifications.

Reference-faithful behavior from ``backend/app/services/alert_service.py``:

* priority matrix (alert_service.py:243-250): watchlist AND geofence ->
  critical; either alone -> high; distance < 0.4 -> medium; else low.
* alert_id format ``{target}_{cam}_{ts}_{priority}`` (:252).
* per-target deque(200) history + queue (:97-98); stats.
* notifications on high/critical via background threads bounded by a
  semaphore (:365-391); per-target global/email/SMS cooldowns 30/60/60 s
  (:47-49); SMTP SSL/STARTTLS with exponential-backoff retries (:444-526);
  Twilio SMS with a mock print fallback (:531-555).
* watchlist/geofence persisted to a config doc and restored at init
  (:123-167) — works against the embedded DocStore or Mongo.

Fixed here (SURVEY.md "defects to fix"): ``count_alerts`` and
``acknowledge_alert`` are real methods (the reference mis-indents them to
module level, :325-356, so its routes silently no-op), and every generated
alert is emitted on the event hub as ``new_alert`` so the dashboard's
listener actually fires.
"""

from __future__ import annotations

import smtplib
import threading
import time
from collections import defaultdict, deque
from datetime import datetime
from email.mime.text import MIMEText

from frp_tpu_torch.utils.logger import audit_event, get_logger

logger = get_logger("frp.platform.alerts")


class AlertService:
    def __init__(
        self,
        camera_metadata: dict | None = None,
        config_collection=None,
        log_alert_fn=None,
        event_hub=None,
        email_config: dict | None = None,
        sms_config: dict | None = None,
        cooldown_seconds: float = 30.0,
        email_cooldown: float = 60.0,
        sms_cooldown: float = 60.0,
        notify_workers: int = 4,
        email_retries: int = 2,
        email_retry_base: float = 1.5,
    ):
        self.camera_metadata = camera_metadata if camera_metadata is not None else {}
        self._config_coll = config_collection
        self._log_alert_fn = log_alert_fn
        self._event_hub = event_hub
        self.email_config = email_config or {"enabled": False, "recipients": []}
        self.sms_config = sms_config or {"enabled": False, "recipients": []}
        self.cooldown_seconds = cooldown_seconds
        self.email_cooldown = email_cooldown
        self.sms_cooldown = sms_cooldown
        self.email_retries = email_retries
        self.email_retry_base = email_retry_base

        # bounded: appended per alert forever in a 24/7 process
        self.alert_queue: deque = deque(maxlen=1000)
        self.alert_history: dict[str, deque] = defaultdict(lambda: deque(maxlen=200))
        self.watchlist: set[str] = set()
        self.geofence_zones: dict[str, dict] = {}
        self.subscribers: dict[str, list] = defaultdict(list)
        self._last_sent: dict[tuple, float] = {}
        self._lock = threading.RLock()
        self._notif_semaphore = threading.BoundedSemaphore(max(1, notify_workers))
        self.stats = {
            "total_alerts": 0,
            "notifications_sent": 0,
            "notifications_failed": 0,
        }
        self._init_from_store()

    # -- persistence (alert_service.py:123-167) ----------------------------
    def _init_from_store(self):
        if self._config_coll is None:
            return
        try:
            doc = self._config_coll.find_one({"name": "watchlist"})
            if doc:
                self.watchlist = set(doc.get("data", []))
            doc = self._config_coll.find_one({"name": "geofences"})
            if doc:
                self.geofence_zones = dict(doc.get("data", {}))
        except Exception:
            logger.exception("failed to restore alert config (non-fatal)")

    def _persist(self, name: str, data):
        if self._config_coll is None:
            return
        try:
            from frp_tpu_torch.platform.schemas import ConfigModel

            doc = ConfigModel(name=name, data=data).model_dump()
            self._config_coll.update_one(
                {"name": doc["name"]}, {"$set": {"data": doc["data"]}}, upsert=True
            )
        except Exception:
            logger.exception("failed to persist %s (non-fatal)", name)

    # -- watchlist ----------------------------------------------------------
    def add_to_watchlist(self, target: str) -> dict:
        with self._lock:
            self.watchlist.add(target)
            self._persist("watchlist", sorted(self.watchlist))
        audit_event("watchlist_add", {"target": target})
        return {"success": True, "watchlist": sorted(self.watchlist)}

    def remove_from_watchlist(self, target: str) -> dict:
        with self._lock:
            existed = target in self.watchlist
            self.watchlist.discard(target)
            self._persist("watchlist", sorted(self.watchlist))
        return {"success": existed, "watchlist": sorted(self.watchlist)}

    def get_watchlist(self) -> list:
        with self._lock:
            return sorted(self.watchlist)

    # -- geofences (named camera-ID sets, alert_service.py:172-224) ---------
    def add_geofence(self, name: str, camera_ids: list, description: str = "") -> dict:
        with self._lock:
            self.geofence_zones[name] = {
                "cameras": [int(c) for c in camera_ids],
                "description": description,
                "created_at": datetime.now().isoformat(),
            }
            self._persist("geofences", self.geofence_zones)
        return {"success": True, "zone": name}

    def remove_geofence(self, name: str) -> dict:
        with self._lock:
            existed = name in self.geofence_zones
            self.geofence_zones.pop(name, None)
            self._persist("geofences", self.geofence_zones)
        return {"success": existed}

    def get_geofences(self) -> dict:
        with self._lock:
            return dict(self.geofence_zones)

    def check_geofence(self, camera_id: int) -> list:
        with self._lock:
            return [
                name
                for name, zone in self.geofence_zones.items()
                if int(camera_id) in zone.get("cameras", [])
            ]

    # -- alert generation ----------------------------------------------------
    @staticmethod
    def _confidence(distance: float) -> str:
        # one banding rule, shared with compare + tracking (ops.matching)
        from frp_tpu_torch.ops.matching import confidence_level

        return confidence_level(distance)

    def generate_alert(
        self,
        target_name: str,
        camera_id: int,
        distance: float,
        timestamp: datetime | None = None,
        metadata: dict | None = None,
    ) -> dict:
        if timestamp is None:
            timestamp = datetime.now()
        with self._lock:
            info = self.camera_metadata.get(int(camera_id), {})
            camera_name = info.get("name", f"Camera {camera_id}")
            geo = tuple(info.get("geo", (0.0, 0.0)))

            zones = self.check_geofence(camera_id)
            watchlisted = target_name in self.watchlist
            in_geofence = bool(zones)
            high_conf = distance < 0.4

            if watchlisted and in_geofence:
                priority = "critical"
            elif watchlisted or in_geofence:
                priority = "high"
            elif high_conf:
                priority = "medium"
            else:
                priority = "low"

            alert_id = f"{target_name}_{camera_id}_{timestamp.timestamp()}_{priority}"
            alert = {
                "alert_id": alert_id,
                "target": target_name,
                "camera_id": int(camera_id),
                "camera_name": camera_name,
                "geo": geo,
                "distance": round(float(distance), 4),
                "confidence": self._confidence(distance),
                "priority": priority,
                "geofence_zones": zones,
                "is_watchlisted": watchlisted,
                "timestamp": timestamp.isoformat(),
                "metadata": metadata or {},
                "acknowledged": False,
            }
            self.alert_queue.append(alert)
            self.alert_history[target_name].append(alert)
            self.stats["total_alerts"] += 1
            notify = priority in ("high", "critical")
            if notify:
                self._dispatch_notification(alert)

        if self._log_alert_fn is not None:
            try:
                self._log_alert_fn(
                    camera_id=camera_id,
                    camera_name=camera_name,
                    geo=str(geo),
                    target=target_name,
                    distance=distance,
                    priority=priority,
                )
            except Exception:
                logger.exception("log_alert failed (non-fatal)")
        if self._event_hub is not None:
            self._event_hub.emit("new_alert", alert)
        self._notify_subscribers(target_name, alert)

        return {
            "alert_id": alert_id,
            "triggered": True,
            "priority": priority,
            "geofence_zones": zones,
            "notification_sent": notify,
        }

    # -- retrieval -------------------------------------------------------
    def history_snapshot(self, limit: int = 10) -> dict:
        """Per-target alert history, snapshotted under the lock — handlers
        iterating alert_history lock-free raced generate_alert's first-time
        key inserts (dict changed size during iteration -> 500)."""
        with self._lock:
            return {t: list(dq)[-limit:] for t, dq in self.alert_history.items()}

    def get_alerts(
        self,
        target_name: str | None = None,
        priority: str | None = None,
        since: datetime | None = None,
        limit: int | None = None,
    ) -> list:
        with self._lock:
            alerts = [a for dq in self.alert_history.values() for a in dq]
        if target_name:
            alerts = [a for a in alerts if a["target"] == target_name]
        if priority:
            alerts = [a for a in alerts if a["priority"] == priority]
        if since:
            alerts = [
                a for a in alerts if datetime.fromisoformat(a["timestamp"]) > since
            ]
        alerts.sort(key=lambda a: a["timestamp"], reverse=True)
        return alerts[:limit] if limit else alerts

    def count_alerts(
        self,
        target_name: str | None = None,
        priority: str | None = None,
        since: datetime | None = None,
    ) -> int:
        """A real method here — mis-indented to module scope in the reference
        (alert_service.py:325-340), which made routes fall back to len()."""
        return len(self.get_alerts(target_name, priority, since))

    def acknowledge_alert(
        self, alert_id: str, acknowledged_by: str, notes: str | None = None
    ) -> dict:
        """Real method (reference defect at alert_service.py:342-356)."""
        with self._lock:
            for dq in self.alert_history.values():
                for alert in dq:
                    if alert.get("alert_id") == alert_id:
                        alert["acknowledged"] = True
                        alert["acknowledged_by"] = acknowledged_by
                        alert["acknowledged_at"] = datetime.now().isoformat()
                        if notes:
                            alert["acknowledgement_notes"] = notes
                        return {
                            "success": True,
                            "message": f"Alert {alert_id} acknowledged",
                        }
        return {"success": False, "message": f"Alert {alert_id} not found"}

    def get_latest_alert(self, target_name: str | None = None) -> dict | None:
        alerts = self.get_alerts(target_name=target_name, limit=1)
        return alerts[0] if alerts else None

    def get_statistics(self) -> dict:
        with self._lock:
            by_priority: dict[str, int] = defaultdict(int)
            for dq in self.alert_history.values():
                for a in dq:
                    by_priority[a["priority"]] += 1
            return {
                **self.stats,
                "by_priority": dict(by_priority),
                "watchlist_size": len(self.watchlist),
                "geofence_zones": len(self.geofence_zones),
                "targets_with_alerts": len(self.alert_history),
            }

    # -- subscribers ----------------------------------------------------
    def subscribe(self, target: str, callback) -> None:
        with self._lock:
            self.subscribers[target].append(callback)

    def _notify_subscribers(self, target: str, alert: dict):
        with self._lock:
            subs = list(self.subscribers.get(target, [])) + list(
                self.subscribers.get("*", [])
            )
        for cb in subs:
            try:
                cb(alert)
            except Exception:
                logger.exception("alert subscriber failed")

    # -- notifications -----------------------------------------------------
    def _dispatch_notification(self, alert: dict):
        target = alert["target"]
        now = time.time()
        if now - self._last_sent.get((target, "global"), 0) < self.cooldown_seconds:
            return
        self._last_sent[(target, "global")] = now

        def runner():
            if not self._notif_semaphore.acquire(timeout=10):
                logger.warning("notification semaphore busy; skipping %s", alert["alert_id"])
                return
            try:
                self._send_notifications(alert)
            finally:
                self._notif_semaphore.release()

        threading.Thread(target=runner, daemon=True).start()

    def _send_notifications(self, alert: dict):
        target = alert["target"]
        now = time.time()
        if (
            self.email_config.get("enabled")
            and now - self._last_sent.get((target, "email"), 0) >= self.email_cooldown
        ):
            ok = self._send_email(alert)
            self._last_sent[(target, "email")] = now
            with self._lock:
                self.stats["notifications_sent" if ok else "notifications_failed"] += 1
        if (
            self.sms_config.get("enabled")
            and now - self._last_sent.get((target, "sms"), 0) >= self.sms_cooldown
        ):
            ok = self._send_sms(alert)
            self._last_sent[(target, "sms")] = now
            with self._lock:
                self.stats["notifications_sent" if ok else "notifications_failed"] += 1

    def _send_email(self, alert: dict) -> bool:
        cfg = self.email_config
        body = (
            f"Alert: {alert['target']} detected at {alert['camera_name']} "
            f"({alert['timestamp']}) priority={alert['priority']} "
            f"distance={alert['distance']}"
        )
        msg = MIMEText(body)
        msg["Subject"] = f"[{alert['priority'].upper()}] Face alert: {alert['target']}"
        msg["From"] = cfg.get("sender_email", "")
        msg["To"] = ", ".join(cfg.get("recipients", []))
        delay = self.email_retry_base  # ALERT_EMAIL_RETRY_BASE
        for attempt in range(self.email_retries + 1):
            try:
                port = int(cfg.get("smtp_port", 587))
                if port == 465:
                    server = smtplib.SMTP_SSL(cfg["smtp_server"], port, timeout=10)
                else:
                    server = smtplib.SMTP(cfg["smtp_server"], port, timeout=10)
                    server.starttls()
                with server:
                    if cfg.get("sender_email") and cfg.get("sender_password"):
                        server.login(cfg["sender_email"], cfg["sender_password"])
                    server.send_message(msg)
                return True
            except Exception as e:
                logger.warning("email attempt %d failed: %s", attempt + 1, e)
                if attempt < self.email_retries:  # no pointless sleep after
                    time.sleep(delay)             # the final attempt (holds a
                    delay *= 2                    # notification semaphore slot)
        return False

    def _send_sms(self, alert: dict) -> bool:
        cfg = self.sms_config
        body = f"Alert: {alert['target']} at {alert['camera_name']} ({alert['priority']})"
        try:
            from twilio.rest import Client  # optional dependency

            client = Client(cfg.get("api_key"), cfg.get("api_secret"))
            for to in cfg.get("recipients", []):
                client.messages.create(
                    body=body, from_=cfg.get("sender_phone"), to=to
                )
            return True
        except ImportError:
            # mock fallback (alert_service.py:550-553)
            logger.info("[MOCK SMS] %s -> %s", body, cfg.get("recipients"))
            return True
        except Exception:
            logger.exception("twilio send failed")
            return False

    # -- runtime reconfig (alert_service.py:596-621) --------------------------
    def configure_email(self, **kwargs) -> dict:
        with self._lock:
            self.email_config.update(kwargs)
            return {"success": True, "config": {
                k: ("***" if "password" in k else v)
                for k, v in self.email_config.items()
            }}

    def configure_sms(self, **kwargs) -> dict:
        with self._lock:
            self.sms_config.update(kwargs)
            return {"success": True, "config": {
                k: ("***" if "secret" in k.lower() else v)
                for k, v in self.sms_config.items()
            }}

    def health_check(self) -> dict:
        with self._lock:
            return {
                "status": "healthy",
                "total_alerts": self.stats["total_alerts"],
                "watchlist_size": len(self.watchlist),
                "geofence_zones": len(self.geofence_zones),
                "email_enabled": bool(self.email_config.get("enabled")),
                "sms_enabled": bool(self.sms_config.get("enabled")),
            }
