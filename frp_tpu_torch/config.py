"""Typed configuration for the platform, backed by environment variables.

The PyTorch port's own copy of ``frp_tpu/config.py`` (the port imports
nothing of the JAX package); tests/test_torch_host.py holds the two equal.

The reference scatters ~60 ``os.getenv`` calls across modules (reference
``backend/.env``, ``backend/app/services/face_service.py:43-48``,
``alert_service.py:47-67``, ``thumbnail_cache.py:29-36``, ``state.py:117-125``).
We keep the same env-var *names* for drop-in compatibility but back them with
one frozen dataclass constructed once (SURVEY.md section 5 "Config / flag
system" rebuild note).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, fields


def _get(name, default, cast=None):
    """Read an env var; ``name`` may be a tuple of names tried in order —
    the FIRST set one wins. Aliases exist for drop-in compatibility with the
    reference's exact env names (e.g. its SMTP_SERVER beside our SMTP_HOST):
    a migrating user's .env keeps working unchanged
    (tests/test_env_coverage.py locks every env key the reference code
    reads to a mapping here or a documented exemption)."""
    names = (name,) if isinstance(name, str) else name
    raw = None
    for n in names:
        raw = os.getenv(n)
        if raw is not None:
            break
    if raw is None:
        return default
    cast = cast or type(default)
    if cast is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    try:
        return cast(raw)
    except (TypeError, ValueError):
        return default


@dataclass(frozen=True)
class Config:
    # --- face recognition core (reference face_service.py:43-48) ---
    face_tolerance: float = 0.6          # FACE_TOLERANCE — match decision threshold
    face_model: str = "retinaface"       # FACE_MODEL (reference default "hog")
    face_batch_workers: int = 4          # FACE_BATCH_WORKERS
    encode_cache_ttl: float = 300.0      # FACE_CACHE_TTL seconds
    encode_cache_size: int = 256         # FACE_CACHE_SIZE
    min_face_quality: float = 50.0       # MIN_FACE_QUALITY upload gate (face.py:221-238)
    embed_dim: int = 128                 # EMBED_DIM — dlib-compatible 128-d default
    embedder_arch: str = "mobilefacenet"  # EMBEDDER_ARCH: mobilefacenet | iresnet18/34/50/100
    # EMBED_FLIP_TTA: embed the aligned crop AND its horizontal mirror,
    # renormalize the sum — synthetic identities are bilaterally symmetric
    # (train/synthetic.py make_identity), so the mirror is the same identity
    # at mirrored yaw and averaging denoises pose (measured: tier-2 e2e TPR
    # 0.755 -> 0.821, benchmarks/flip_tta_profile.json). Doubles embed-stage
    # FLOPs, so it ships default-off; the distance scale is mode-keyed
    # (calibration_{arch}_flip.json) and the engine refuses a cross-mode one.
    embed_flip_tta: bool = False

    # --- detector (reference deepfake_utils.py:41-48) ---
    det_size: int = 640                  # DET_SIZE square detector input
    det_conf_threshold: float = 0.5      # DET_CONF_THRESHOLD
    det_nms_threshold: float = 0.4       # DET_NMS_THRESHOLD (IoU)
    det_nms_iom_threshold: float = 0.5   # DET_NMS_IOM_THRESHOLD int/min-area; <=0 off
    max_faces_per_frame: int = 16        # MAX_FACES padded detection slots
    pre_nms_topk: int = 256              # PRE_NMS_TOPK candidates kept before NMS

    # --- engine ---
    mesh_data_axis: str = "data"
    mesh_model_axis: str = "model"
    frames_per_batch: int = 8            # FRAMES_PER_BATCH device batch (streams x frames)
    compute_dtype: str = "bfloat16"      # COMPUTE_DTYPE for conv/matmul activations
    donate_frames: bool = True

    # --- cameras (reference main.py:75-81, camera.py) ---
    frame_skip: int = 1                  # FRAME_SKIP
    camera_scan_interval: float = 1.0    # CAMERA_SCAN_INTERVAL
    # temporal-delta frame transfer (engine.submit_encoded): ship only
    # changed blocks of the I420 batch between scans — bit-exact, falls
    # back to raw keyframes automatically (engine/batching.DeltaEncoder)
    delta_transfer: bool = True          # FRP_DELTA_TRANSFER
    camera_health_interval: float = 30.0 # HEALTH_CHECK_INTERVAL (health_checks.py)

    # --- alerts (reference alert_service.py:47-67) ---
    alert_cooldown: float = 30.0         # ALERT_COOLDOWN seconds per target
    email_cooldown: float = 60.0         # EMAIL_COOLDOWN
    sms_cooldown: float = 60.0           # SMS_COOLDOWN
    notify_workers: int = 4              # NOTIFY_WORKERS semaphore bound
    smtp_host: str = ""                  # SMTP_HOST
    smtp_port: int = 587                 # SMTP_PORT
    smtp_user: str = ""                  # SMTP_USER
    smtp_password: str = ""              # SMTP_PASSWORD
    alert_email_to: str = ""             # ALERT_EMAIL_TO
    twilio_sid: str = ""                 # TWILIO_SID
    twilio_token: str = ""               # TWILIO_TOKEN
    twilio_from: str = ""                # TWILIO_FROM
    alert_sms_to: str = ""               # ALERT_SMS_TO

    # --- tracking (reference tracking_service.py) ---
    detection_cooldown: float = 10.0     # DETECTION_COOLDOWN per (person, camera)
    loiter_minutes: float = 15.0         # LOITER_MINUTES suspicious dwell
    speed_limit_kmh: float = 10.0        # SPEED_LIMIT_KMH anomaly threshold

    # --- deepfake (reference deepfake.py:63-65) ---
    deepfake_max_frames: int = 20        # DEEPFAKE_MAX_FRAMES per video
    deepfake_threshold: float = 0.5      # DEEPFAKE_THRESHOLD mean fake prob
    deepfake_cache_ttl: float = 1800.0   # DEEPFAKE_CACHE_TTL (30 min dedup)

    # --- storage / persistence ---
    data_dir: str = "data"               # DATA_DIR
    mongo_uri: str = ""                  # MONGO_URI ("" -> embedded document store)
    redis_url: str = ""                  # REDIS_URL ("" -> in-proc cache only)
    snapshot_cache_mb: int = 200         # SNAPSHOT_CACHE_MB disk quota
    snapshot_ttl: float = 30.0           # SNAPSHOT_TTL in-proc LRU TTL
    upload_max_mb: int = 10              # UPLOAD_MAX_MB (face.py:138-150)

    # --- federated learning (reference federated.py) ---
    fl_min_clients: int = 2              # FL_MIN_CLIENTS aggregation gate
    fl_history_limit: int = 100          # FL_HISTORY_LIMIT bounded history

    # --- logging (reference logger.py) ---
    enable_logging: bool = True          # ENABLE_LOGGING
    log_json: bool = False               # LOG_JSON
    log_dir: str = "logs"                # LOG_DIR

    # --- async jobs (reference async_task_manager.py) ---
    async_max_workers: int = 1           # ASYNC_MAX_WORKERS
    job_retention: float = 3600.0        # JOB_RETENTION_SECONDS

    # --- models ---
    model_idle_unload_seconds: float = 600.0  # MODEL_IDLE_UNLOAD_SECONDS (main.py:206-222)
    model_max_memory_mb: float = 6400.0  # MODEL_MAX_MEMORY_MB (state.py:117-125); <=0 = unlimited
    weights_dir: str = "weights"         # WEIGHTS_DIR

    # --- round-5 reference env parity (every key the reference code reads;
    # defaults copied from its getenv calls — tests/test_env_coverage.py) ---
    # alerts (alert_service.py:47-67) — enabled flags AND with configured
    # credentials; default True = our r1-r4 semantics (credentials present
    # means intent to send), explicit false disables like the reference
    email_enabled: bool = True           # EMAIL_ENABLED
    sms_enabled: bool = True             # SMS_ENABLED
    email_retries: int = 2               # ALERT_EMAIL_RETRIES
    email_retry_base: float = 1.5        # ALERT_EMAIL_RETRY_BASE
    # snapshot enhancer (enhancer.py:49-89)
    enhancer_jpeg_quality: int = 85      # ENHANCER_JPEG_QUALITY
    enhancer_max_pixels: int = 4_000_000  # ENHANCER_MAX_PIXELS
    enhancer_sharpen: bool = True        # ENHANCER_SHARPEN
    enhancer_upscale: float = 2.0        # ENHANCER_UPSCALE_FACTOR
    # thumbnail cache (thumbnail_cache.py:29-36)
    thumb_mem_items: int = 512           # THUMB_CACHE_MEM_ITEMS
    thumb_redis_ttl: float = 30.0        # THUMB_CACHE_REDIS_TTL
    thumb_max_disk_bytes: int = 0        # THUMB_MAX_DISK_BYTES; 0 -> snapshot_cache_mb
    thumb_disk_cleanup_batch: int = 10   # THUMB_DISK_CLEANUP_BATCH
    # camera health loop (health_checks.py:29-35)
    camera_backoff_base: float = 10.0    # CAMERA_BACKOFF_BASE
    camera_backoff_max: float = 3600.0   # CAMERA_BACKOFF_MAX
    health_request_timeout: float = 4.0  # CAMERA_HEALTH_REQUEST_TIMEOUT
    health_concurrency: int = 10         # HEALTH_CONCURRENCY
    # storage (db.py:84-160)
    mongo_db_name: str = "face_recognition_db"  # MONGO_DB_NAME
    mongo_connect_retries: int = 3       # MONGO_CONNECT_RETRIES
    mongo_connect_backoff: float = 2.0   # MONGO_CONNECT_BACKOFF
    cameras_collection: str = "cameras"  # CAMERAS_COLLECTION
    # crypto (db.py:171-209)
    encryption_key_path: str = ""        # ENCRYPTION_KEY_PATH; "" -> data_dir/.encryption_key
    disable_encryption: bool = False     # DISABLE_ENCRYPTION
    # logging (logger.py)
    log_level: str = "INFO"              # LOG_LEVEL
    log_max_bytes: int = 10 * 1024 * 1024  # LOG_MAX_BYTES
    log_backup_count: int = 5            # LOG_BACKUP_COUNT
    app_log_file: str = "app.log"        # APP_LOG_FILE (relative to log_dir)
    audit_log_file: str = "audit.log"    # AUDIT_LOG_FILE (relative to log_dir)
    audit_to_db: bool = False            # AUDIT_TO_DB
    db_log_level: str = "INFO"           # DB_LOG_LEVEL (frp.platform.dbops logger)
    socketio_log_level: str = "WARNING"  # SOCKETIO_LOG_LEVEL / ENGINEIO_LOG_LEVEL
    access_log_level: str = "WARNING"    # UVICORN_ACCESS_LOG_LEVEL (frp.api.http)
    # directory layout ("" -> derived from data_dir/log_dir as before)
    upload_dir: str = ""                 # UPLOAD_DIR / UPLOADS_DIR / FACE_UPLOAD_DIR
    face_backup_dir: str = ""            # FACE_BACKUP_DIR
    snapshot_dir: str = ""               # SNAPSHOT_DIR (thumbnail disk tier)
    deepfake_upload_dir: str = ""        # DEEPFAKE_UPLOAD_DIR
    deepfake_logs_dir: str = ""          # DEEPFAKE_LOGS_DIR
    fl_dir: str = ""                     # FL_DIR
    async_tmp_dir: str = ""              # ASYNC_TMP_DIR (accepted for .env
    # compat; our async search decodes uploads in memory — no temp files —
    # so this only sets where a future file-based job would stage)
    # async jobs (async_tasks.py)
    async_max_upload_bytes: int = 5 * 1024 * 1024  # ASYNC_MAX_UPLOAD_BYTES
    # HTTP edge (main.py:44-59, snapshot.py:37)
    frontend_origins: str = "*"          # FRONTEND_ORIGINS (comma list or *)
    snapshot_cache_control: str = "public, max-age=5"  # SNAPSHOT_CACHE_CONTROL

    extra: dict = field(default_factory=dict)

    # --- derived directory layout (reference defaults when unset) ---
    def uploads_path(self) -> str:
        return self.upload_dir or os.path.join(self.data_dir, "uploads")

    def backups_path(self) -> str:
        return self.face_backup_dir or os.path.join(self.data_dir, "backups")

    def snapshots_path(self) -> str:
        # the thumbnail cache's DISK tier (reference thumbnail_cache.py:29)
        return self.snapshot_dir or os.path.join(
            self.data_dir, "snapshots_cache")

    def deepfake_uploads_path(self) -> str:
        return self.deepfake_upload_dir or os.path.join(
            self.data_dir, "temp_uploads")

    def deepfake_logs_path(self) -> str:
        return self.deepfake_logs_dir or os.path.join(
            self.data_dir, "deepfake_logs")

    def fl_path(self) -> str:
        return self.fl_dir or os.path.join(self.data_dir, "fl_weights")

    def async_tmp_path(self) -> str:
        return self.async_tmp_dir or os.path.join(self.data_dir, "async_tmp")

    def encryption_key_file(self) -> str:
        return self.encryption_key_path or os.path.join(
            self.data_dir, ".encryption_key")

    def thumb_disk_quota_bytes(self) -> int:
        return (self.thumb_max_disk_bytes
                or self.snapshot_cache_mb * 1024 * 1024)


_ENV_MAP = {
    "face_tolerance": ("FACE_TOLERANCE", float),
    "face_model": ("FACE_MODEL", str),
    "face_batch_workers": ("FACE_BATCH_WORKERS", int),
    "encode_cache_ttl": ("FACE_CACHE_TTL", float),
    "encode_cache_size": ("FACE_CACHE_SIZE", int),
    "min_face_quality": ("MIN_FACE_QUALITY", float),
    "embed_dim": ("EMBED_DIM", int),
    "embedder_arch": ("EMBEDDER_ARCH", str),
    "embed_flip_tta": ("EMBED_FLIP_TTA", bool),
    "det_size": ("DET_SIZE", int),
    "det_conf_threshold": ("DET_CONF_THRESHOLD", float),
    "det_nms_threshold": ("DET_NMS_THRESHOLD", float),
    "det_nms_iom_threshold": ("DET_NMS_IOM_THRESHOLD", float),
    "max_faces_per_frame": ("MAX_FACES", int),
    "pre_nms_topk": ("PRE_NMS_TOPK", int),
    "frames_per_batch": ("FRAMES_PER_BATCH", int),
    "compute_dtype": ("COMPUTE_DTYPE", str),
    "frame_skip": ("FRAME_SKIP", int),
    "camera_scan_interval": ("CAMERA_SCAN_INTERVAL", float),
    "delta_transfer": ("FRP_DELTA_TRANSFER", bool),
    "camera_health_interval": (
        ("HEALTH_CHECK_INTERVAL", "CAMERA_HEALTH_INTERVAL"), float),
    "alert_cooldown": (("ALERT_COOLDOWN", "ALERT_COOLDOWN_SECONDS"), float),
    "email_cooldown": (("EMAIL_COOLDOWN", "ALERT_EMAIL_COOLDOWN_SECONDS"), float),
    "sms_cooldown": (("SMS_COOLDOWN", "ALERT_SMS_COOLDOWN_SECONDS"), float),
    "notify_workers": (("NOTIFY_WORKERS", "ALERT_THREAD_POOL"), int),
    "smtp_host": (("SMTP_HOST", "SMTP_SERVER"), str),
    "smtp_port": ("SMTP_PORT", int),
    "smtp_user": (("SMTP_USER", "SENDER_EMAIL"), str),
    "smtp_password": (("SMTP_PASSWORD", "SENDER_PASSWORD"), str),
    "alert_email_to": (("ALERT_EMAIL_TO", "EMAIL_RECIPIENTS"), str),
    "twilio_sid": (("TWILIO_SID", "TWILIO_ACCOUNT_SID"), str),
    "twilio_token": (("TWILIO_TOKEN", "TWILIO_AUTH_TOKEN"), str),
    "twilio_from": (("TWILIO_FROM", "TWILIO_SENDER_PHONE"), str),
    "alert_sms_to": (("ALERT_SMS_TO", "SMS_RECIPIENTS"), str),
    "detection_cooldown": ("DETECTION_COOLDOWN", float),
    "loiter_minutes": ("LOITER_MINUTES", float),
    "speed_limit_kmh": ("SPEED_LIMIT_KMH", float),
    "deepfake_max_frames": ("DEEPFAKE_MAX_FRAMES", int),
    "deepfake_threshold": ("DEEPFAKE_THRESHOLD", float),
    "deepfake_cache_ttl": ("DEEPFAKE_CACHE_TTL", float),
    "data_dir": ("DATA_DIR", str),
    "mongo_uri": ("MONGO_URI", str),
    "redis_url": ("REDIS_URL", str),
    "snapshot_cache_mb": ("SNAPSHOT_CACHE_MB", int),
    "snapshot_ttl": (("SNAPSHOT_TTL", "THUMB_CACHE_MEM_TTL"), float),
    "upload_max_mb": ("UPLOAD_MAX_MB", int),
    "fl_min_clients": ("FL_MIN_CLIENTS", int),
    "fl_history_limit": ("FL_HISTORY_LIMIT", int),
    "enable_logging": ("ENABLE_LOGGING", bool),
    "log_json": (("LOG_JSON", "LOG_FORMAT_JSON"), bool),
    "log_dir": (("LOG_DIR", "LOGS_DIR"), str),
    "async_max_workers": ("ASYNC_MAX_WORKERS", int),
    "job_retention": (("JOB_RETENTION_SECONDS", "ASYNC_JOB_RETENTION"), float),
    "model_idle_unload_seconds": ("MODEL_IDLE_UNLOAD_SECONDS", float),
    "model_max_memory_mb": ("MODEL_MAX_MEMORY_MB", float),
    "weights_dir": ("WEIGHTS_DIR", str),
    # round-5 reference env parity (defaults copied from reference getenv)
    "email_enabled": ("EMAIL_ENABLED", bool),
    "sms_enabled": ("SMS_ENABLED", bool),
    "email_retries": ("ALERT_EMAIL_RETRIES", int),
    "email_retry_base": ("ALERT_EMAIL_RETRY_BASE", float),
    "enhancer_jpeg_quality": ("ENHANCER_JPEG_QUALITY", int),
    "enhancer_max_pixels": ("ENHANCER_MAX_PIXELS", int),
    "enhancer_sharpen": ("ENHANCER_SHARPEN", bool),
    "enhancer_upscale": ("ENHANCER_UPSCALE_FACTOR", float),
    "thumb_mem_items": ("THUMB_CACHE_MEM_ITEMS", int),
    "thumb_redis_ttl": ("THUMB_CACHE_REDIS_TTL", float),
    "thumb_max_disk_bytes": ("THUMB_MAX_DISK_BYTES", int),
    "thumb_disk_cleanup_batch": ("THUMB_DISK_CLEANUP_BATCH", int),
    "camera_backoff_base": ("CAMERA_BACKOFF_BASE", float),
    "camera_backoff_max": ("CAMERA_BACKOFF_MAX", float),
    "health_request_timeout": ("CAMERA_HEALTH_REQUEST_TIMEOUT", float),
    "health_concurrency": ("HEALTH_CONCURRENCY", int),
    "mongo_db_name": ("MONGO_DB_NAME", str),
    "mongo_connect_retries": ("MONGO_CONNECT_RETRIES", int),
    "mongo_connect_backoff": ("MONGO_CONNECT_BACKOFF", float),
    "cameras_collection": ("CAMERAS_COLLECTION", str),
    "encryption_key_path": ("ENCRYPTION_KEY_PATH", str),
    "disable_encryption": ("DISABLE_ENCRYPTION", bool),
    "log_level": ("LOG_LEVEL", str),
    "log_max_bytes": ("LOG_MAX_BYTES", int),
    "log_backup_count": ("LOG_BACKUP_COUNT", int),
    "app_log_file": ("APP_LOG_FILE", str),
    "audit_log_file": ("AUDIT_LOG_FILE", str),
    "audit_to_db": ("AUDIT_TO_DB", bool),
    "db_log_level": ("DB_LOG_LEVEL", str),
    "socketio_log_level": (("SOCKETIO_LOG_LEVEL", "ENGINEIO_LOG_LEVEL"), str),
    "access_log_level": ("UVICORN_ACCESS_LOG_LEVEL", str),
    "upload_dir": (("UPLOAD_DIR", "UPLOADS_DIR", "FACE_UPLOAD_DIR"), str),
    "face_backup_dir": ("FACE_BACKUP_DIR", str),
    "snapshot_dir": ("SNAPSHOT_DIR", str),
    "deepfake_upload_dir": ("DEEPFAKE_UPLOAD_DIR", str),
    "deepfake_logs_dir": ("DEEPFAKE_LOGS_DIR", str),
    "fl_dir": ("FL_DIR", str),
    "async_tmp_dir": ("ASYNC_TMP_DIR", str),
    "async_max_upload_bytes": ("ASYNC_MAX_UPLOAD_BYTES", int),
    "frontend_origins": ("FRONTEND_ORIGINS", str),
    "snapshot_cache_control": ("SNAPSHOT_CACHE_CONTROL", str),
}

# reference env keys that intentionally have NO mapping here, with the
# reason (tests/test_env_coverage.py asserts every key the reference code
# reads is either mapped above or exempted below)
ENV_EXEMPT = {
    "MODEL_CPU_MODE": "torch CPU/GPU device pick; the JAX platform is "
                      "chosen by jax.config/plugin, not per-model",
    "CAM_ID": "reference tools/mock_camera_worker.py local knob; our "
              "tools/mock_camera_worker.py reads its own env",
    "IMAGE_DIR": "mock_camera_worker tool knob (see CAM_ID)",
    "INGEST_URL": "mock_camera_worker tool knob (see CAM_ID)",
    "INTERVAL": "mock_camera_worker tool knob (see CAM_ID)",
}


# One-knob serving profiles (round 5). FRP_PROFILE=accuracy switches the
# embedder to the measured hard-tier configuration — iresnet18 + flip-TTA,
# the combination that clears the pre-registered tier-2 e2e TPR>=0.80 gate
# (BASELINE.md "Hard-tier capacity path"; mode-keyed distance scale in
# weights/calibration_iresnet18_flip.json). Explicitly set EMBEDDER_ARCH /
# EMBED_FLIP_TTA env values still win over the preset, and an unknown
# profile name fails loudly rather than silently serving the wrong models.
PROFILES = {
    "throughput": {},  # the defaults: MobileFaceNet, single-pass embed
    "accuracy": {"embedder_arch": "iresnet18", "embed_flip_tta": True},
}


def _apply_profile(values: dict) -> None:
    profile = os.getenv("FRP_PROFILE", "").strip().lower()
    if not profile:
        return
    if profile not in PROFILES:
        raise ValueError(
            f"FRP_PROFILE={profile!r} unknown; valid: {sorted(PROFILES)}")
    for key, preset in PROFILES[profile].items():
        env = _ENV_MAP[key][0]
        names = (env,) if isinstance(env, str) else env
        if not any(os.getenv(n) is not None for n in names):
            values[key] = preset


def load_config(**overrides) -> Config:
    """Build a Config from the environment, with keyword overrides winning."""
    defaults = Config()
    values = {}
    for f in fields(Config):
        if f.name == "extra":
            continue
        env = _ENV_MAP.get(f.name)
        base = getattr(defaults, f.name)
        values[f.name] = _get(env[0], base, env[1]) if env else base
    _apply_profile(values)
    values.update(overrides)
    return Config(**values)


_config: Config | None = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = load_config()
    return _config


def set_config(cfg: Config) -> None:
    global _config
    _config = cfg
