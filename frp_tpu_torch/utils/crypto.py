"""Embedding encryption at rest — Fernet (AES-128-CBC + HMAC), matching the
reference's scheme and key handling (``backend/app/utils/db.py:171-267``):
key auto-generated on first run into ``{data_dir}/.encryption_key`` chmod 600;
embeddings serialized as JSON, Fernet-encrypted, stored base64 (str).

Encryption stays host-side; the gallery is decrypted ONCE at startup into the
device-resident matrix (BASELINE.json "encrypted-embedding gallery" flow) —
unlike the reference, which never re-hydrates ENCODINGS after boot.
"""

from __future__ import annotations

import json
import os

import numpy as np

try:
    from cryptography.fernet import Fernet, InvalidToken
except ImportError:  # pragma: no cover
    Fernet = None
    InvalidToken = Exception


class EmbeddingCipher:
    def __init__(self, data_dir: str = "data", key: bytes | None = None,
                 key_path: str = "", disabled: bool = False):
        # key_path: ENCRYPTION_KEY_PATH override; disabled:
        # DISABLE_ENCRYPTION (reference db.py:171-209) — embeddings are
        # then stored with the explicit "plain:" marker, never silently
        self._fernet = None
        if Fernet is None or disabled:
            return
        if key is None:
            key = self._load_or_create_key(data_dir, key_path)
        self._fernet = Fernet(key)

    @staticmethod
    def _load_or_create_key(data_dir: str, key_path: str = "") -> bytes:
        path = key_path or os.path.join(data_dir, ".encryption_key")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if os.path.exists(path):
            with open(path, "rb") as f:
                return f.read().strip()
        key = Fernet.generate_key()
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
        except FileExistsError:
            # another process won the O_EXCL race between our exists-check
            # and the open (server + bench starting together): use ITS key —
            # crashing here aborted Context construction entirely
            with open(path, "rb") as f:
                return f.read().strip()
        with os.fdopen(fd, "wb") as f:
            f.write(key)
        return key

    @property
    def available(self) -> bool:
        return self._fernet is not None

    def encrypt_embedding(self, embedding) -> str:
        payload = json.dumps(np.asarray(embedding, np.float64).tolist()).encode()
        if self._fernet is None:  # plaintext fallback, clearly marked
            return "plain:" + payload.decode()
        return self._fernet.encrypt(payload).decode()

    def decrypt_embedding(self, token: str) -> np.ndarray | None:
        try:
            if token.startswith("plain:"):
                data = token[len("plain:"):].encode()
            elif self._fernet is None:
                return None
            else:
                data = self._fernet.decrypt(token.encode())
            return np.asarray(json.loads(data), np.float64)
        except (InvalidToken, ValueError, json.JSONDecodeError):
            return None
