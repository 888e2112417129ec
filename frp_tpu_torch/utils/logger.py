"""Logging and audit vertical — reference semantics from ``backend/app/utils/
logger.py:121-259`` and the per-target logs in ``db.py:281-326``:

* ``setup_logger`` — console + rotating file logs/app.log (10 MB x 5),
  optional JSON-lines format, idempotent.
* separate non-propagating audit logger -> logs/audit.log, JSON-lines,
  chmod 600; ``audit_event(type, payload)`` redacts sensitive keys.
* per-target detection logs as logs/{target}.txt + .json.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from datetime import datetime, timezone
from logging.handlers import RotatingFileHandler

SENSITIVE_KEYS = {
    "embedding", "embeddings", "image", "frame", "password", "token",
    "secret", "key", "encoding", "encodings",
}

_lock = threading.Lock()
_configured: dict = {}


class JsonFormatter(logging.Formatter):
    def format(self, record):
        payload = {
            "ts": datetime.now(timezone.utc).isoformat(),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        return json.dumps(payload)


def setup_logger(
    name: str = "frp",
    log_dir: str = "logs",
    json_format: bool = False,
    level: int | str = logging.INFO,
    _console_only: bool = False,
    max_bytes: int = 10 * 1024 * 1024,
    backup_count: int = 5,
    app_log_file: str = "app.log",
) -> logging.Logger:
    """Idempotent for identical settings; a call with DIFFERENT settings
    reconfigures. (get_logger auto-configures console-only at import time —
    without the reconfigure path, Context's explicit setup_logger(log_dir,
    log_json) was a guaranteed no-op and user settings were ignored.)"""
    if isinstance(level, str):  # LOG_LEVEL env ("INFO", "debug", ...)
        level = getattr(logging, level.upper(), logging.INFO)
    with _lock:
        prev = _configured.get(name)
        settings = (log_dir, json_format, level, _console_only,
                    max_bytes, backup_count, app_log_file)
        if prev is not None and prev[1] == settings:
            return prev[0]
        logger = logging.getLogger(name)
        logger.setLevel(level)
        logger.propagate = False
        for h in list(logger.handlers):  # reconfigure: drop old handlers
            logger.removeHandler(h)
        fmt = (
            JsonFormatter()
            if json_format
            else logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if not _console_only:
            try:
                os.makedirs(log_dir, exist_ok=True)
                fh = RotatingFileHandler(
                    os.path.join(log_dir, app_log_file),  # APP_LOG_FILE
                    maxBytes=max_bytes,        # LOG_MAX_BYTES
                    backupCount=backup_count,  # LOG_BACKUP_COUNT
                )
                fh.setFormatter(fmt)
                logger.addHandler(fh)
            except OSError:
                pass
        _configured[name] = (logger, settings)
        return logger


def get_logger(name: str) -> logging.Logger:
    # console-only auto-config: module-level get_logger calls run at import
    # time, and creating ./logs as an import side effect (or locking in the
    # default file location before Context reads the real cfg) is wrong
    if "frp" not in _configured:
        setup_logger(_console_only=True)
    child = logging.getLogger(name)
    if name != "frp":
        child.setLevel(logging.NOTSET)  # inherit the root's level
        child.propagate = True  # bubble to the 'frp' root's handlers
    return child


# ---------------------------------------------------------------------------
# audit
# ---------------------------------------------------------------------------

_audit_logger = None
_audit_sink = None  # optional callable(record) — AUDIT_TO_DB wiring
_audit_file = "audit.log"


def set_audit_sink(sink) -> None:
    """AUDIT_TO_DB (reference logger.py/db.py): also deliver every audit
    record to a storage sink (e.g. the audit collection). None disables."""
    global _audit_sink
    _audit_sink = sink


def set_audit_file(filename: str) -> None:
    """AUDIT_LOG_FILE override; takes effect before the first audit_event."""
    global _audit_file
    _audit_file = filename or "audit.log"


def _get_audit_logger(log_dir: str = "logs") -> logging.Logger:
    global _audit_logger
    with _lock:
        if _audit_logger is not None:
            return _audit_logger
        logger = logging.getLogger("frp.audit")
        logger.setLevel(logging.INFO)
        logger.propagate = False
        try:
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, _audit_file)
            fh = logging.FileHandler(path)
            fh.setFormatter(logging.Formatter("%(message)s"))
            logger.addHandler(fh)
            try:
                os.chmod(path, 0o600)
            except OSError:
                pass
        except OSError:
            logger.addHandler(logging.NullHandler())
        _audit_logger = logger
        return logger


def redact_sensitive(payload):
    """Recursively replace sensitive values (logger.py:96-119 semantics)."""
    if isinstance(payload, dict):
        return {
            k: "[REDACTED]" if k.lower() in SENSITIVE_KEYS else redact_sensitive(v)
            for k, v in payload.items()
        }
    if isinstance(payload, (list, tuple)):
        return [redact_sensitive(v) for v in payload]
    return payload


def audit_event(event_type: str, payload: dict | None = None, log_dir: str = "logs"):
    logger = _get_audit_logger(log_dir)
    record = {
        "ts": datetime.now(timezone.utc).isoformat(),
        "type": event_type,
        "payload": redact_sensitive(payload or {}),
    }
    logger.info(json.dumps(record, default=str))
    if _audit_sink is not None:
        try:
            _audit_sink(record)
        except Exception:  # the sink must never break the audited operation
            logging.getLogger("frp.audit").debug("audit sink failed")
    return record


# ---------------------------------------------------------------------------
# per-target detection logs (db.py:281-326)
# ---------------------------------------------------------------------------

def create_target_log_files(target: str, log_dir: str = "logs"):
    os.makedirs(log_dir, exist_ok=True)
    txt = os.path.join(log_dir, f"{target}.txt")
    jsn = os.path.join(log_dir, f"{target}.json")
    for path, init in ((txt, ""), (jsn, "[]")):
        if not os.path.exists(path):
            with open(path, "w") as f:
                f.write(init)
    return txt, jsn


def append_target_log(target: str, entry: dict, log_dir: str = "logs"):
    txt, jsn = create_target_log_files(target, log_dir)
    line = (
        f"{entry.get('timestamp', datetime.now().isoformat())} | "
        f"camera={entry.get('camera_id')} ({entry.get('camera_name', '?')}) | "
        f"distance={entry.get('distance')}\n"
    )
    # serialized: the read-modify-write of {target}.json loses entries under
    # concurrent appenders, and a shared ".tmp" name can interleave writers
    # from other processes (hence the pid suffix too)
    with _lock:
        with open(txt, "a") as f:
            f.write(line)
        try:
            with open(jsn, "r") as f:
                items = json.load(f)
        except (OSError, json.JSONDecodeError):
            items = []
        items.append(entry)
        tmp = f"{jsn}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(items, f, default=str)
        os.replace(tmp, jsn)
