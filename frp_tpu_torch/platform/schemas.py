"""Pydantic document schemas — reference ``backend/app/models/person.py``
contract: FaceModel (Fernet-token embedding), TrackingRecordModel with
geo-range + confidence-enum validators, AlertLogModel (geo-as-string legacy),
DeepfakeLogModel with bbox-shape validator, ConfigModel (named config doc).
"""

from __future__ import annotations

from datetime import datetime
from typing import Any, List, Literal, Optional, Tuple

from pydantic import BaseModel, Field, field_validator


class FaceModel(BaseModel):
    """A stored face: embedding is the Fernet token (str), never plaintext."""

    target: str = Field(min_length=1, max_length=128)
    embedding: str
    updated_at: Optional[str] = None
    quality_score: Optional[float] = Field(default=None, ge=0, le=100)

    @field_validator("updated_at", mode="before")
    @classmethod
    def _iso(cls, v):
        if isinstance(v, datetime):
            return v.isoformat()
        return v


class TrackingRecordModel(BaseModel):
    person: str
    camera_id: int = Field(ge=0)
    camera_name: Optional[str] = None
    geo: Tuple[float, float] = (0.0, 0.0)
    distance: float = Field(ge=0)
    confidence: Literal["high", "medium", "low"]
    timestamp: str
    speed_kmh: float = Field(default=0.0, ge=0)
    dwell_time_seconds: float = Field(default=0.0, ge=0)

    @field_validator("geo")
    @classmethod
    def _geo_range(cls, v):
        lat, lon = v
        if not (-90.0 <= lat <= 90.0) or not (-180.0 <= lon <= 180.0):
            raise ValueError(f"geo out of range: {v}")
        return v


class AlertLogModel(BaseModel):
    target: str
    camera_id: int = Field(ge=0)
    camera_name: Optional[str] = None
    geo: str = "(0.0, 0.0)"  # legacy string form (reference person.py:159-204)
    distance: float = Field(ge=0)
    priority: Literal["critical", "high", "medium", "low"] = "low"
    timestamp: str


class DeepfakeLogModel(BaseModel):
    result: Literal["real", "fake", "no_faces"]
    confidence: Literal["high", "medium", "low", "none"]
    timestamp: str
    frames_sampled: int = Field(default=0, ge=0)
    boxes: Optional[List[List[float]]] = None

    @field_validator("boxes")
    @classmethod
    def _bbox_shape(cls, v):
        if v is not None:
            for box in v:
                if len(box) != 4:
                    raise ValueError(f"bbox must have 4 coords, got {len(box)}")
        return v


class ConfigModel(BaseModel):
    name: str = Field(min_length=1)
    data: Any = None
