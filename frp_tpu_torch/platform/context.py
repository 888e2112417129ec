"""AppContext: the one place the port's object graph is built (port of
``frp_tpu/platform/context.py``).

It owns a port ``RecognitionEngine`` (built on the card unless the caller
names another device, or injected), the store, the cipher, the cameras and
every service of the JAX context: face service, tracking, alerts, deepfake,
federated learning, async tasks, health, thumbnails, tracer and timers. A
``mesh`` (a single-process ``parallel.Mesh``) goes to the engine, which
splits every batch over its data positions, and to the FL service, whose
combine then runs over it, as the JAX context's does.
"""

from __future__ import annotations

import logging
import os
import threading

from frp_tpu_torch.config import Config, get_config
from frp_tpu_torch.platform.alerts import AlertService
from frp_tpu_torch.platform.async_tasks import AsyncTaskManager
from frp_tpu_torch.platform.dbops import ensure_indexes, make_log_alert, make_save_detection
from frp_tpu_torch.platform.deepfake import DeepfakeService
from frp_tpu_torch.platform.face_service import FaceService
from frp_tpu_torch.platform.federated import FederatedService
from frp_tpu_torch.platform.health import HealthMonitor
from frp_tpu_torch.platform.state import (
    DEFAULT_CAMERA_CONFIGS,
    CameraRegistry,
    EventHub,
    ModelManager,
)
from frp_tpu_torch.platform.tracking import TrackingService
from frp_tpu_torch.utils.crypto import EmbeddingCipher
from frp_tpu_torch.utils.docstore import connect
from frp_tpu_torch.utils.logger import get_logger, set_audit_file, set_audit_sink, setup_logger
from frp_tpu_torch.utils.profiling import DeviceTracer, StageTimers
from frp_tpu_torch.utils.thumbnail_cache import ThumbnailCache

logger = get_logger("frp.platform.context")


class AppContext:
    def __init__(
        self,
        cfg: Config | None = None,
        engine=None,
        camera_configs: list | None = None,
        device=None,
        mesh=None,
    ):
        self.cfg = cfg or get_config()
        setup_logger(
            "frp", self.cfg.log_dir, self.cfg.log_json,
            level=self.cfg.log_level,           # LOG_LEVEL
            max_bytes=self.cfg.log_max_bytes,   # LOG_MAX_BYTES
            backup_count=self.cfg.log_backup_count,  # LOG_BACKUP_COUNT
            app_log_file=self.cfg.app_log_file,      # APP_LOG_FILE
        )
        # subsystem log levels (reference *_LOG_LEVEL env names map onto
        # the corresponding named loggers here)
        for name, lvl in (("frp.platform.dbops", self.cfg.db_log_level),
                          ("frp.api.socketio", self.cfg.socketio_log_level),
                          ("frp.api.http", self.cfg.access_log_level)):
            if lvl:
                logging.getLogger(name).setLevel(
                    getattr(logging, lvl.upper(), logging.INFO))
        set_audit_file(self.cfg.audit_log_file)  # AUDIT_LOG_FILE
        os.makedirs(self.cfg.data_dir, exist_ok=True)

        # storage (never raises; embedded store by default)
        self.db, self.db_backend = connect(
            self.cfg.mongo_uri, os.path.join(self.cfg.data_dir, "store"),
            db_name=self.cfg.mongo_db_name,          # MONGO_DB_NAME
            retries=self.cfg.mongo_connect_retries,  # MONGO_CONNECT_RETRIES
            backoff=self.cfg.mongo_connect_backoff,  # MONGO_CONNECT_BACKOFF
        )
        ensure_indexes(self.db)
        if self.cfg.audit_to_db:  # AUDIT_TO_DB: audit records also land in
            audit_coll = self.db["audit"]  # the audit collection

            set_audit_sink(lambda rec: audit_coll.insert_one(dict(rec)))
        else:
            # a PREVIOUS context may have installed a sink into its (now
            # stale) store — audit records must not keep flowing there
            set_audit_sink(None)
        self.cipher = EmbeddingCipher(
            self.cfg.data_dir,
            key_path=self.cfg.encryption_key_file(),  # ENCRYPTION_KEY_PATH
            disabled=self.cfg.disable_encryption,     # DISABLE_ENCRYPTION
        )

        # engine (injectable for tests); the card unless `device` or `mesh`
        # says otherwise, and no card raises
        if engine is None:
            from frp_tpu_torch.engine.pipeline import RecognitionEngine

            engine = RecognitionEngine(self.cfg, device=device, mesh=mesh)
        self.engine = engine

        # shared state
        self.events = EventHub()
        self.cameras = CameraRegistry()
        self.cameras.init_cameras(camera_configs or DEFAULT_CAMERA_CONFIGS)
        self.models = ModelManager(
            self.cfg.model_idle_unload_seconds,
            max_memory_mb=self.cfg.model_max_memory_mb,  # MODEL_MAX_MEMORY_MB
        )
        self.thumbnails = ThumbnailCache(
            self.cfg.snapshots_path(),               # SNAPSHOT_DIR disk tier
            mem_entries=self.cfg.thumb_mem_items,    # THUMB_CACHE_MEM_ITEMS
            ttl=self.cfg.snapshot_ttl,               # THUMB_CACHE_MEM_TTL
            disk_quota_mb=self.cfg.snapshot_cache_mb,
            redis_url=self.cfg.redis_url,
            redis_ttl=self.cfg.thumb_redis_ttl,      # THUMB_CACHE_REDIS_TTL
            disk_quota_bytes=self.cfg.thumb_max_disk_bytes,  # THUMB_MAX_DISK_BYTES
            cleanup_batch=self.cfg.thumb_disk_cleanup_batch,
        )

        # services
        self.face_service = FaceService(
            engine,
            faces_collection=self.db["faces"],
            cipher=self.cipher,
            tolerance=self.cfg.face_tolerance,
            cache_ttl=self.cfg.encode_cache_ttl,
            cache_size=self.cfg.encode_cache_size,
            backup_dir=self.cfg.backups_path(),  # FACE_BACKUP_DIR
        )
        self.tracking = TrackingService(
            camera_metadata=self.cameras.metadata(),
            cooldown_seconds=self.cfg.detection_cooldown,
            persist_fn=make_save_detection(self.db),
            event_hub=self.events,
        )
        self.alerts = AlertService(
            camera_metadata=self.cameras.metadata(),
            config_collection=self.db["config"],
            log_alert_fn=make_log_alert(self.db, self.cfg.log_dir),
            event_hub=self.events,
            email_config={
                # EMAIL_ENABLED gate ANDed with configured credentials
                "enabled": self.cfg.email_enabled and bool(self.cfg.smtp_host),
                "smtp_server": self.cfg.smtp_host,
                "smtp_port": self.cfg.smtp_port,
                "sender_email": self.cfg.smtp_user,
                "sender_password": self.cfg.smtp_password,
                "recipients": [e for e in self.cfg.alert_email_to.split(",") if e],
            },
            sms_config={
                "enabled": self.cfg.sms_enabled and bool(self.cfg.twilio_sid),
                "api_key": self.cfg.twilio_sid,
                "api_secret": self.cfg.twilio_token,
                "sender_phone": self.cfg.twilio_from,
                "recipients": [p for p in self.cfg.alert_sms_to.split(",") if p],
            },
            cooldown_seconds=self.cfg.alert_cooldown,
            email_cooldown=self.cfg.email_cooldown,
            sms_cooldown=self.cfg.sms_cooldown,
            notify_workers=self.cfg.notify_workers,
            email_retries=self.cfg.email_retries,        # ALERT_EMAIL_RETRIES
            email_retry_base=self.cfg.email_retry_base,  # ALERT_EMAIL_RETRY_BASE
        )
        self.deepfake = DeepfakeService(
            engine,
            deepfake_collection=self.db["deepfakes"],
            max_frames=self.cfg.deepfake_max_frames,
            threshold=self.cfg.deepfake_threshold,
            cache_ttl=self.cfg.deepfake_cache_ttl,
            logs_dir=self.cfg.deepfake_logs_path(),  # DEEPFAKE_LOGS_DIR
            weights_loaded=bool(
                (getattr(engine, "weights_loaded", None) or {}).get("spoof")
            ),
        )
        self.federated = FederatedService(
            weights_dir=self.cfg.fl_path(),  # FL_DIR
            min_clients=self.cfg.fl_min_clients,
            history_limit=self.cfg.fl_history_limit,
            mesh=mesh,
        )
        self.async_tasks = AsyncTaskManager(
            face_service=self.face_service,
            event_hub=self.events,
            jobs_collection=self.db["async_jobs"],
            max_workers=self.cfg.async_max_workers,
            retention_seconds=self.cfg.job_retention,
        )
        self.health = HealthMonitor(
            self.cameras,
            self.db[self.cfg.cameras_collection],  # CAMERAS_COLLECTION
            self.cfg.camera_health_interval,
            backoff_base=self.cfg.camera_backoff_base,    # CAMERA_BACKOFF_BASE
            backoff_cap=self.cfg.camera_backoff_max,      # CAMERA_BACKOFF_MAX
            request_timeout=self.cfg.health_request_timeout,
            concurrency=self.cfg.health_concurrency,      # HEALTH_CONCURRENCY
        )
        self.tracer = DeviceTracer(os.path.join(self.cfg.data_dir, "traces"))
        self.timers = StageTimers()

        # keep service metadata views in sync when cameras change
        self._meta_lock = threading.Lock()

    def refresh_camera_metadata(self):
        """Call after camera add/update/delete so tracking + alerts see it."""
        meta = self.cameras.metadata()
        with self._meta_lock:
            self.tracking.camera_metadata = meta
            self.alerts.camera_metadata = meta

    def startup(self, hydrate: bool = True, start_health: bool = True):
        if hydrate:
            self.face_service.hydrate()
        if start_health:
            self.health.start()

    def shutdown(self):
        self.health.stop()
        self.async_tasks.shutdown()
        self.tracking.shutdown()
        self.cameras.close_all()
