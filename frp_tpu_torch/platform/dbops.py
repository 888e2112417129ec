"""Store-level logging helpers — reference ``backend/app/utils/db.py``
semantics: log_alert with a 10 s store-side dedup window + audit emit
(:347-396), log_deepfake (:402-454), safe inserts with retry (:331-342),
index bootstrap (:60-79).
"""

from __future__ import annotations

import time
from datetime import datetime, timedelta

from frp_tpu_torch.platform.schemas import AlertLogModel, TrackingRecordModel
from frp_tpu_torch.utils.logger import append_target_log, audit_event, get_logger

logger = get_logger("frp.platform.dbops")

ALERT_DEDUP_SECONDS = 10.0


def ensure_indexes(db) -> None:
    """Idempotent compound indexes (db.py:60-79). No-op metadata on the
    embedded store; real indexes on Mongo."""
    try:
        db["faces"].create_index([("target", 1)], unique=True)
        db["logs"].create_index([("target", 1), ("timestamp", -1)])
        db["tracking"].create_index([("person", 1), ("timestamp", -1)])
        db["deepfakes"].create_index([("timestamp", -1)])
    except Exception:
        logger.exception("index bootstrap failed (non-fatal)")


def safe_insert(collection, doc: dict, retries: int = 2):
    """AutoReconnect-style retry (db.py:331-342)."""
    for attempt in range(retries + 1):
        try:
            return collection.insert_one(doc)
        except Exception as e:
            if attempt == retries:
                logger.warning("insert failed after retries: %s", e)
                return None
            time.sleep(0.2 * (attempt + 1))


def make_log_alert(db, log_dir: str = "logs"):
    """Build a log_alert(camera_id, camera_name, geo, target, distance)
    closure with the 10 s dedup window (db.py:347-396)."""
    logs = db["logs"]

    def log_alert(camera_id, camera_name, geo, target, distance, priority="low"):
        now = datetime.now()
        cutoff = (now - timedelta(seconds=ALERT_DEDUP_SECONDS)).isoformat()
        dup = logs.find_one(
            {"target": target, "camera_id": int(camera_id), "timestamp": {"$gte": cutoff}}
        )
        if dup is not None:
            return {"logged": False, "deduplicated": True}
        # schema-validated document (reference person.py:159-204 AlertLogModel
        # semantics incl. the legacy geo-as-string form); a malformed alert
        # never reaches the store
        entry = AlertLogModel(
            target=target,
            camera_id=int(camera_id),
            camera_name=camera_name,
            geo=str(geo),
            distance=round(float(distance), 4),
            priority=priority,
            timestamp=now.isoformat(),
        ).model_dump()
        safe_insert(logs, entry)
        append_target_log(target, entry, log_dir)
        audit_event("alert_logged", entry)
        return {"logged": True, "deduplicated": False}

    return log_alert


def make_save_detection(db):
    """Tracking persistence closure (db.py:563-572 — defined twice in the
    reference; once here)."""
    tracking = db["tracking"]

    def save_detection(detection: dict):
        # schema gate (reference person.py:74-153 TrackingRecordModel: geo
        # range + confidence enum); invalid records are dropped with a
        # warning rather than corrupting the store (background path)
        try:
            doc = TrackingRecordModel(**detection).model_dump()
        except Exception as e:
            logger.warning("tracking record rejected by schema: %s", e)
            return
        doc["geo"] = list(doc["geo"])
        safe_insert(tracking, doc)

    return save_detection


def load_tracking_history(db, person: str | None = None, limit: int = 500) -> list:
    """Aggregation-pipeline history load (db.py:584-604)."""
    stages = []
    if person:
        stages.append({"$match": {"person": person}})
    stages.append({"$sort": {"timestamp": -1}})
    stages.append({"$limit": limit})
    try:
        return list(db["tracking"].aggregate(stages))
    except Exception:
        logger.exception("tracking history load failed")
        return []
