"""Cross-camera tracking service — reference-faithful analytics host math.

Formula-for-formula port of the *behavior* of ``backend/app/services/
tracking_service.py`` (all citations inline): per-(person, camera) cooldown
dedup, haversine inter-camera speed, contiguous-trailing-block dwell time,
heatmaps + hourly patterns + transition counts, rule-based anomaly score,
Markov next-camera trajectory prediction, suspicious-pattern analysis,
movement-pattern comparison, and the full export. This is cheap host math by
design (SURVEY.md section 7 layer 4) — the engine does detection; this does the
bookkeeping.
"""

from __future__ import annotations

import math
import threading
from collections import defaultdict, deque
from datetime import datetime, timedelta

from frp_tpu_torch.utils.logger import get_logger

logger = get_logger("frp.platform.tracking")


def haversine_km(geo1, geo2) -> float:
    """Great-circle distance (tracking_service.py:548-560, R=6371 km)."""
    lat1, lon1 = float(geo1[0]), float(geo1[1])
    lat2, lon2 = float(geo2[0]), float(geo2[1])
    r = 6371.0
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dlat = p2 - p1
    dlon = math.radians(lon2 - lon1)
    a = math.sin(dlat / 2) ** 2 + math.cos(p1) * math.cos(p2) * math.sin(dlon / 2) ** 2
    return r * 2 * math.atan2(math.sqrt(a), math.sqrt(1 - a))


def confidence_band(distance: float) -> str:
    # one banding rule, shared with compare + alerts (ops.matching)
    from frp_tpu_torch.ops.matching import confidence_level

    return confidence_level(distance)


class TrackingService:
    def __init__(
        self,
        camera_metadata: dict | None = None,
        cooldown_seconds: float = 10.0,
        history_limit: int = 1000,
        persist_fn=None,
        event_hub=None,
    ):
        self.camera_metadata = camera_metadata if camera_metadata is not None else {}
        self.cooldown = timedelta(seconds=cooldown_seconds)
        self._lock = threading.RLock()
        self._persist_fn = persist_fn
        self._event_hub = event_hub
        from concurrent.futures import ThreadPoolExecutor

        self._persist_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tracking-persist"
        )

        self.movement_history: dict[str, deque] = defaultdict(
            lambda: deque(maxlen=history_limit)
        )
        self.current_locations: dict[str, int] = {}
        self.last_detection: dict[tuple, datetime] = {}
        self.stats = {"total_detections": 0, "unique_persons": 0, "camera_switches": 0}
        self._location_heatmap: dict[int, int] = defaultdict(int)
        self._person_heatmaps: dict[str, dict] = defaultdict(lambda: defaultdict(int))
        self._hourly_patterns: dict[str, dict] = defaultdict(lambda: defaultdict(int))
        self._camera_transitions: dict[int, dict] = defaultdict(lambda: defaultdict(int))
        self._speed_history: dict[str, list] = defaultdict(list)
        self._dwell_times: dict[str, list] = defaultdict(list)
        self._anomaly_scores: dict[str, list] = defaultdict(list)
        self._trajectory_cache: dict[str, dict] = {}

    # ------------------------------------------------------------------
    def record_detection(
        self,
        person_name: str,
        camera_id: int,
        distance: float,
        timestamp: datetime | None = None,
    ) -> dict:
        """tracking_service.py:94-228 semantics."""
        if timestamp is None:
            timestamp = datetime.now()
        with self._lock:
            try:
                camera_id = int(camera_id)
            except (TypeError, ValueError):
                return {"recorded": False, "message": "Invalid camera_id"}

            key = (person_name, camera_id)
            last = self.last_detection.get(key)
            if last is not None and timestamp - last < self.cooldown:
                return {
                    "recorded": False,
                    "is_new_location": False,
                    "previous_location": None,
                    "duplicate": True,
                    "message": f"Duplicate detection (cooldown: {int(self.cooldown.total_seconds())}s)",
                }

            info = self.camera_metadata.get(camera_id, {}) or {}
            camera_name = info.get("name", f"Camera {camera_id}")
            geo = tuple(info.get("geo", (0.0, 0.0)))

            previous = self.current_locations.get(person_name)
            is_new_location = previous != camera_id

            speed_kmh = 0.0
            if is_new_location and previous is not None:
                speed_kmh = self._calc_speed(person_name, previous, camera_id, timestamp)
                if speed_kmh > 0:
                    self._speed_history[person_name].append(speed_kmh)

            dwell = 0.0
            if previous is not None:
                dwell = self._calc_dwell(person_name, previous, timestamp)
                if dwell > 0:
                    self._dwell_times[person_name].append(dwell)

            record = {
                "person": person_name,
                "camera_id": camera_id,
                "camera_name": camera_name,
                "geo": geo,
                "distance": float(distance),
                "confidence": confidence_band(distance),
                "timestamp": timestamp.isoformat(),
                "speed_kmh": round(float(speed_kmh), 2),
                "dwell_time_seconds": round(float(dwell), 2),
            }

            self.current_locations[person_name] = camera_id
            was_new = len(self.movement_history[person_name]) == 0
            self.movement_history[person_name].append(record)
            self.last_detection[key] = timestamp

            self.stats["total_detections"] += 1
            if was_new:
                self.stats["unique_persons"] += 1
            if is_new_location and previous is not None:
                self.stats["camera_switches"] += 1
                self._camera_transitions[previous][camera_id] += 1

            self._location_heatmap[camera_id] += 1
            self._person_heatmaps[person_name][camera_id] += 1
            self._hourly_patterns[person_name][timestamp.hour] += 1

            anomaly = self._calc_anomaly(person_name, camera_id, speed_kmh, timestamp)
            self._anomaly_scores[person_name].append(anomaly)
            self._update_trajectory(person_name)

        # outside the lock: persistence + live events. One shared worker —
        # a fresh Thread per detection (reference tracking_service.py:212-216)
        # piles up short-lived threads that each sleep through store retries
        # during outages
        if self._persist_fn is not None:
            self._persist_pool.submit(self._persist_fn, dict(record))
        if self._event_hub is not None:
            self._event_hub.emit("update_movement_log", record)
            self._event_hub.emit(
                "update_tracking_feed",
                {"person": person_name, "camera_id": camera_id, "timestamp": record["timestamp"]},
            )

        return {
            "recorded": True,
            "is_new_location": is_new_location,
            "previous_location": previous,
            "duplicate": False,
            "message": "Detection recorded successfully",
            "detection": record,
            "speed_kmh": round(float(speed_kmh), 2),
            "dwell_time_seconds": round(float(dwell), 2),
            "anomaly_score": round(float(anomaly), 3),
        }

    # -- formulas (cited) ----------------------------------------------------
    def _calc_speed(self, person, from_cam, to_cam, now) -> float:
        """tracking_service.py:491-516: haversine / hours since last seen at
        the origin camera."""
        from_geo = self.camera_metadata.get(from_cam, {}).get("geo", (0.0, 0.0))
        to_geo = self.camera_metadata.get(to_cam, {}).get("geo", (0.0, 0.0))
        dist_km = haversine_km(from_geo, to_geo)
        if dist_km == 0:
            return 0.0
        last = self.last_detection.get((person, from_cam))
        if last is None:
            return 0.0
        hours = (now - last).total_seconds() / 3600.0
        if hours <= 0:
            return 0.0
        return float(dist_km / hours)

    def _calc_dwell(self, person, camera_id, now) -> float:
        """tracking_service.py:521-543: time since start of the most recent
        contiguous trailing block at camera_id."""
        history = self.movement_history.get(person)
        if not history:
            return 0.0
        first_time = None
        for det in reversed(history):
            if det["camera_id"] == camera_id:
                first_time = datetime.fromisoformat(det["timestamp"])
            else:
                if first_time:
                    break
        if first_time is None:
            return 0.0
        return float((now - first_time).total_seconds())

    def _calc_anomaly(self, person, camera_id, speed_kmh, now) -> float:
        """tracking_service.py:565-590: speed>10 +0.3 / >6 +0.15; night <6 or
        >22 +0.3, shoulder hours +0.15; visit-ratio >0.5 +0.4 / >0.3 +0.2;
        capped at 1.0."""
        score = 0.0
        if speed_kmh > 10:
            score += 0.3
        elif speed_kmh > 6:
            score += 0.15
        hour = now.hour
        if hour < 6 or hour > 22:
            score += 0.3
        elif hour < 8 or hour > 20:
            score += 0.15
        total = self._location_heatmap.get(camera_id, 0)
        mine = self._person_heatmaps[person].get(camera_id, 0)
        if total > 0:
            ratio = mine / total
            if ratio > 0.5:
                score += 0.4
            elif ratio > 0.3:
                score += 0.2
        return min(1.0, float(score))

    def _update_trajectory(self, person):
        """tracking_service.py:595-623: Markov argmax over the transition row
        of the person's current camera."""
        history = self.movement_history.get(person)
        if not history or len(history) < 2:
            return
        last_camera = history[-1]["camera_id"]
        transitions = self._camera_transitions.get(last_camera)
        if transitions:
            predicted = max(transitions.items(), key=lambda kv: kv[1])[0]
            total = sum(transitions.values()) or 1
            self._trajectory_cache[person] = {
                "current_camera": last_camera,
                "predicted_next_camera": predicted,
                "confidence": transitions[predicted] / total,
                "timestamp": datetime.now().isoformat(),
            }

    # -- queries ---------------------------------------------------------
    def get_movement_history(self, person: str, limit: int | None = None) -> list:
        with self._lock:
            hist = list(self.movement_history.get(person, []))
        return hist[-limit:] if limit else hist

    def get_all_movements(self, limit_per_person: int = 50) -> dict:
        with self._lock:
            return {
                p: list(h)[-limit_per_person:] for p, h in self.movement_history.items()
            }

    def get_current_locations(self) -> dict:
        with self._lock:
            return dict(self.current_locations)

    def get_movement_path(self, person: str) -> list:
        """Distinct consecutive cameras (tracking_service.py:335-346)."""
        with self._lock:
            history = list(self.movement_history.get(person, []))
        path = []
        prev = None
        for h in history:
            if h["camera_id"] != prev:
                path.append(
                    {
                        "camera_id": h["camera_id"],
                        "camera_name": h["camera_name"],
                        "timestamp": h["timestamp"],
                    }
                )
                prev = h["camera_id"]
        return path

    def get_predicted_trajectory(self, person: str) -> dict | None:
        with self._lock:
            return self._trajectory_cache.get(person)

    def get_heatmap(self, person: str | None = None) -> dict:
        with self._lock:
            if person:
                return dict(self._person_heatmaps.get(person, {}))
            return dict(self._location_heatmap)

    def get_time_patterns(self, person: str | None = None) -> dict:
        with self._lock:
            if person:
                return dict(self._hourly_patterns.get(person, {}))
            merged: dict[int, int] = defaultdict(int)
            for pat in self._hourly_patterns.values():
                for h, c in pat.items():
                    merged[h] += c
            return dict(merged)

    def get_transition_matrix(self) -> dict:
        """tracking_service.py:663-673."""
        with self._lock:
            return {
                str(src): dict(dsts) for src, dsts in self._camera_transitions.items()
            }

    def get_speed_statistics(self, person: str | None = None) -> dict:
        with self._lock:
            speeds = (
                list(self._speed_history.get(person, []))
                if person
                else [s for v in self._speed_history.values() for s in v]
            )
        if not speeds:
            return {"count": 0, "average_kmh": 0, "max_kmh": 0, "min_kmh": 0}
        return {
            "count": len(speeds),
            "average_kmh": round(sum(speeds) / len(speeds), 2),
            "max_kmh": round(max(speeds), 2),
            "min_kmh": round(min(speeds), 2),
        }

    def get_dwell_statistics(self, person: str | None = None) -> dict:
        with self._lock:
            dwells = (
                list(self._dwell_times.get(person, []))
                if person
                else [d for v in self._dwell_times.values() for d in v]
            )
        if not dwells:
            return {"count": 0, "average_seconds": 0, "max_seconds": 0}
        return {
            "count": len(dwells),
            "average_seconds": round(sum(dwells) / len(dwells), 2),
            "max_seconds": round(max(dwells), 2),
        }

    def get_statistics(self) -> dict:
        with self._lock:
            return {
                **self.stats,
                "persons_tracked": len(self.movement_history),
                "cameras_active": len(self._location_heatmap),
            }

    def detect_suspicious_patterns(
        self,
        person: str,
        loitering_threshold_minutes: float = 15,
        revisit_threshold: int = 3,
    ) -> dict:
        """tracking_service.py:349-432 semantics: loitering, revisits, A-B-A
        oscillation, speed flags, night-activity>50%, high-anomaly flag."""
        with self._lock:
            if person not in self.movement_history:
                return {
                    "is_suspicious": False,
                    "patterns": [],
                    "loitering_duration": None,
                    "revisit_count": {},
                    "anomaly_score": 0.0,
                }
            history = list(self.movement_history[person])
            patterns: list[str] = []
            duration_minutes = None

            if len(history) >= 2:
                first = datetime.fromisoformat(history[0]["timestamp"])
                last = datetime.fromisoformat(history[-1]["timestamp"])
                duration_minutes = (last - first).total_seconds() / 60.0
                cameras = {h["camera_id"] for h in history}
                if len(cameras) == 1 and duration_minutes > loitering_threshold_minutes:
                    patterns.append(
                        f"Loitering detected: {duration_minutes:.1f} minutes at same location"
                    )

            visits: dict[int, int] = defaultdict(int)
            for h in history:
                visits[h["camera_id"]] += 1
            for cam_id, count in visits.items():
                if count >= revisit_threshold:
                    name = self.camera_metadata.get(cam_id, {}).get(
                        "name", f"Camera {cam_id}"
                    )
                    patterns.append(f"Revisited {name} {count} times")

            if len(history) >= 4:
                recent = [h["camera_id"] for h in history[-4:]]
                if len(set(recent)) == 2 and recent[0] == recent[2]:
                    patterns.append("Rapid back-and-forth movement detected")

            speeds = self._speed_history.get(person, [])
            avg_speed = sum(speeds) / len(speeds) if speeds else 0.0
            max_speed = max(speeds) if speeds else 0.0
            if max_speed > 10:
                patterns.append(f"Unusually high speed detected: {max_speed:.1f} km/h")
            if avg_speed > 6:
                patterns.append(f"High average speed: {avg_speed:.1f} km/h")

            hours = [datetime.fromisoformat(h["timestamp"]).hour for h in history]
            night = sum(1 for h in hours if h < 6 or h > 22)
            if history and night > len(history) * 0.5:
                patterns.append(
                    f"Mostly active during night hours ({night}/{len(history)} detections)"
                )

            scores = self._anomaly_scores.get(person, [0.0])
            avg_anomaly = sum(scores) / len(scores) if scores else 0.0
            if avg_anomaly > 0.7:
                patterns.append(f"High anomaly score: {avg_anomaly:.2f}")

            hourly = self._hourly_patterns.get(person, {})
            return {
                "is_suspicious": len(patterns) > 0 or avg_anomaly > 0.6,
                "patterns": patterns,
                "loitering_duration": duration_minutes,
                "revisit_count": dict(visits),
                "anomaly_score": round(avg_anomaly, 3),
                "speed_analysis": {
                    "average_speed_kmh": round(avg_speed, 2) if speeds else 0,
                    "max_speed_kmh": round(max_speed, 2) if speeds else 0,
                    "min_speed_kmh": round(min(speeds), 2) if speeds else 0,
                },
                "time_analysis": {
                    "total_detections": len(history),
                    "night_detections": night,
                    "most_active_hour": max(hourly.items(), key=lambda kv: kv[1])[0]
                    if hourly
                    else None,
                },
            }

    def get_anomaly_report(self, threshold: float = 0.5) -> list:
        """tracking_service.py:726-760 semantics."""
        with self._lock:
            report = []
            for person, scores in self._anomaly_scores.items():
                if not scores:
                    continue
                avg = sum(scores) / len(scores)
                if avg > threshold:
                    report.append(
                        {
                            "person": person,
                            "average_anomaly_score": round(avg, 3),
                            "max_anomaly_score": round(max(scores), 3),
                            "total_detections": len(scores),
                            "high_anomaly_detections": sum(
                                1 for s in scores if s > threshold
                            ),
                        }
                    )
        report.sort(key=lambda r: r["average_anomaly_score"], reverse=True)
        return report

    def compare_movement_patterns(self, person1: str, person2: str) -> dict:
        """tracking_service.py:766-808: location-overlap .4 + hourly-cosine .4
        + speed-similarity .2."""
        with self._lock:
            if (
                person1 not in self.movement_history
                or person2 not in self.movement_history
            ):
                return {"similarity_score": 0.0, "message": "One or both persons not found"}
            h1 = self._person_heatmaps[person1]
            h2 = self._person_heatmaps[person2]
            all_cams = set(h1) | set(h2)
            if not all_cams:
                return {
                    "similarity_score": 0.0,
                    "common_locations": [],
                    "location_overlap": 0.0,
                }
            common = set(h1) & set(h2)
            overlap = len(common) / len(all_cams)

            v1 = [self._hourly_patterns[person1].get(h, 0) for h in range(24)]
            v2 = [self._hourly_patterns[person2].get(h, 0) for h in range(24)]
            dot = sum(a * b for a, b in zip(v1, v2))
            m1 = math.sqrt(sum(a * a for a in v1))
            m2 = math.sqrt(sum(b * b for b in v2))
            time_sim = dot / (m1 * m2) if m1 > 0 and m2 > 0 else 0.0

            s1 = self._speed_history.get(person1, [])
            s2 = self._speed_history.get(person2, [])
            if s1 and s2:
                speed_sim = max(
                    0.0, 1.0 - abs(sum(s1) / len(s1) - sum(s2) / len(s2)) / 10.0
                )
            else:
                speed_sim = 0.5

            overall = overlap * 0.4 + time_sim * 0.4 + speed_sim * 0.2
            return {
                "similarity_score": round(float(overall), 3),
                "location_overlap": round(float(overlap), 3),
                "time_similarity": round(float(time_sim), 3),
                "speed_similarity": round(float(speed_sim), 3),
                "common_locations": sorted(common),
                "common_location_count": len(common),
                "total_unique_locations": len(all_cams),
            }

    def shutdown(self):
        self._persist_pool.shutdown(wait=False, cancel_futures=True)

    def clear_history(self, person: str | None = None) -> dict:
        with self._lock:
            if person:
                existed = person in self.movement_history
                for store in (
                    self.movement_history,
                    self._person_heatmaps,
                    self._hourly_patterns,
                    self._speed_history,
                    self._dwell_times,
                    self._anomaly_scores,
                    self._trajectory_cache,
                ):
                    store.pop(person, None)
                self.current_locations.pop(person, None)
                # stale cooldown stamps would reject the person's next
                # detection as a duplicate right after the clear (the
                # full-clear branch below already clears last_detection)
                for key in [k for k in self.last_detection if k[0] == person]:
                    self.last_detection.pop(key, None)
                return {"cleared": existed, "person": person}
            n = len(self.movement_history)
            self.movement_history.clear()
            self.current_locations.clear()
            self.last_detection.clear()
            self._location_heatmap.clear()
            self._person_heatmaps.clear()
            self._hourly_patterns.clear()
            self._camera_transitions.clear()
            self._speed_history.clear()
            self._dwell_times.clear()
            self._anomaly_scores.clear()
            self._trajectory_cache.clear()
            return {"cleared": True, "persons": n}

    def export_tracking_data(
        self, person: str | None = None, include_analytics: bool = True
    ) -> dict:
        """tracking_service.py:813-843."""
        export = {
            "export_timestamp": datetime.now().isoformat(),
            "person_filter": person,
        }
        if person:
            export["movement_history"] = self.get_movement_history(person)
            export["current_location"] = self.current_locations.get(person)
            if include_analytics:
                export["analytics"] = {
                    "heatmap": self.get_heatmap(person),
                    "time_patterns": self.get_time_patterns(person),
                    "speed_statistics": self.get_speed_statistics(person),
                    "dwell_statistics": self.get_dwell_statistics(person),
                    "suspicious_patterns": self.detect_suspicious_patterns(person),
                    "predicted_trajectory": self.get_predicted_trajectory(person),
                }
        else:
            export["total_persons"] = len(self.movement_history)
            export["all_movements"] = self.get_all_movements()
            export["current_locations"] = self.get_current_locations()
            if include_analytics:
                export["analytics"] = {
                    "global_heatmap": self.get_heatmap(),
                    "time_patterns": self.get_time_patterns(),
                    "speed_statistics": self.get_speed_statistics(),
                    "dwell_statistics": self.get_dwell_statistics(),
                    "transition_matrix": self.get_transition_matrix(),
                    "anomaly_report": self.get_anomaly_report(),
                    "overall_statistics": self.get_statistics(),
                }
        return export

    def health_check(self) -> dict:
        with self._lock:
            return {
                "status": "healthy",
                "persons_tracked": len(self.movement_history),
                "total_detections": self.stats["total_detections"],
                "cameras_in_metadata": len(self.camera_metadata),
            }
