"""Federated learning service (port of ``frp_tpu/platform/federated.py``) —
client registry, weight uploads, FedAvg aggregation, versioned global
models, rounds.

Behavior contract: the reference keeps its entire FL subsystem inside
``backend/app/routes/federated.py`` (module globals + one RLock). Here it is
a service: same state machine (round/version/status/active set, client
registry, aggregation history bounded at 100, per-client metrics), same
validation semantics (NaN/Inf reject :163-171, layer-structure drift warning
:186-193, layer-name consistency :598-602, shape checks :617-630), same JSON
persistence layout (``data/fl_weights/{client}.json`` and
``global_model_v{N}``, atomic writes :101-121), same weighting options
(equal or contribution-proportional :605-612).

The aggregation math runs through ``frp_tpu_torch.ops.fedavg``'s host
numpy combine in float64 without a mesh; with a mesh of several of this
process's positions, through ``parallel.fedavg_sharded`` (client updates in
f32 split over the data positions, the partials added), as the JAX
service's ``mesh_psum`` branch.
"""

from __future__ import annotations

import json
import os
import threading
from datetime import datetime

import numpy as np

from frp_tpu_torch.ops.fedavg import (
    FedAvgError,
    check_layer_consistency,
    fedavg_combine,
    resolve_weights,
    validate_client_update,
)
from frp_tpu_torch.parallel import DATA_AXIS, fedavg_sharded, pad_clients
from frp_tpu_torch.utils.logger import audit_event, get_logger

logger = get_logger("frp.platform.federated")


class FederatedService:
    def __init__(
        self,
        weights_dir: str = "data/fl_weights",
        min_clients: int = 2,
        history_limit: int = 100,
        mesh=None,
    ):
        self._dir = weights_dir
        self.min_clients = min_clients
        self.history_limit = history_limit
        self.mesh = mesh
        self._lock = threading.RLock()

        self.weights: dict[str, dict] = {}          # client/global -> {layer: np.ndarray}
        self.client_registry: dict[str, dict] = {}
        self.client_metrics: dict[str, dict] = {}
        self.aggregation_history: list[dict] = []
        self.state = {
            "round": 0,
            "version": 0,
            "status": "idle",
            "active_clients": set(),
            "round_started_at": None,
        }
        os.makedirs(weights_dir, exist_ok=True)
        self._warm_load()

    # -- persistence (federated.py:101-121, 302-333) --------------------------
    def _path(self, name: str) -> str:
        safe = "".join(c for c in name if c.isalnum() or c in "._-")
        return os.path.join(self._dir, f"{safe}.json")

    def _persist(self, name: str, update: dict):
        payload = {
            "name": name,
            "saved_at": datetime.now().isoformat(),
            "weights": {k: np.asarray(v).tolist() for k, v in update.items()},
        }
        path = self._path(name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    def _load_from_disk(self, name: str) -> dict | None:
        path = self._path(name)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                payload = json.load(f)
            return {
                k: np.asarray(v, np.float64)
                for k, v in payload.get("weights", {}).items()
            }
        except (OSError, json.JSONDecodeError, ValueError):
            return None

    def _warm_load(self):
        """Re-hydrate clients + latest global model from disk at startup."""
        try:
            files = [f for f in os.listdir(self._dir) if f.endswith(".json")]
        except OSError:
            return
        max_version = 0
        for f in files:
            name = f[:-5]
            loaded = self._load_from_disk(name)
            if loaded is None:
                continue
            self.weights[name] = loaded
            if name.startswith("global_model_v"):
                try:
                    max_version = max(max_version, int(name.split("v")[-1]))
                except ValueError:
                    pass
            else:
                self.client_registry.setdefault(
                    name,
                    {
                        "client_id": name,
                        "registered_at": datetime.now().isoformat(),
                        "contribution_count": 1,
                        "source": "disk",
                    },
                )
        self.state["version"] = max_version
        self.state["round"] = max_version

    # -- client registry (federated.py:417-571) -------------------------------
    def register_client(self, client_id: str, info: dict | None = None) -> dict:
        with self._lock:
            existed = client_id in self.client_registry
            entry = self.client_registry.setdefault(
                client_id,
                {
                    "client_id": client_id,
                    "registered_at": datetime.now().isoformat(),
                    "contribution_count": 0,
                },
            )
            if info:
                entry.update(info)
            return {"success": True, "already_registered": existed, "client": dict(entry)}

    def unregister_client(self, client_id: str) -> dict:
        with self._lock:
            existed = client_id in self.client_registry
            self.client_registry.pop(client_id, None)
            self.client_metrics.pop(client_id, None)
            self.state["active_clients"].discard(client_id)
            return {"success": existed}

    def list_clients(self) -> list:
        with self._lock:
            return [dict(c) for c in self.client_registry.values()]

    # -- weight upload (federated.py:150-265) ----------------------------------
    def upload_weights(self, client_id: str, weights: dict) -> dict:
        if client_id.startswith("global_model"):
            # aggregate() filters these out of the client list; the upload
            # path must too, or a client named global_model_v1 silently
            # clobbers the stored aggregated model in memory AND on disk
            raise FedAvgError("client_id may not start with 'global_model'")
        info = validate_client_update(weights)  # raises FedAvgError on bad input
        arrays = {k: np.asarray(v, np.float64) for k, v in weights.items()}
        with self._lock:
            self.register_client(client_id)
            warning = None
            prev = self.weights.get(client_id)
            if prev is not None and set(prev.keys()) != set(arrays.keys()):
                warning = (
                    "layer structure changed since last upload "
                    f"({sorted(prev.keys())} -> {info['layers']})"
                )
            self.weights[client_id] = arrays
            self.client_registry[client_id]["contribution_count"] = (
                self.client_registry[client_id].get("contribution_count", 0) + 1
            )
            self.client_registry[client_id]["last_upload"] = datetime.now().isoformat()
            self.state["active_clients"].add(client_id)
            m = self.client_metrics.setdefault(
                client_id, {"uploads": 0, "avg_weights_size": 0.0}
            )
            m["uploads"] += 1
            m["avg_weights_size"] += (info["total_params"] - m["avg_weights_size"]) / m[
                "uploads"
            ]
        self._persist(client_id, arrays)
        audit_event("fl_upload", {"client": client_id, "layers": info["layers"]})
        return {
            "success": True,
            "client_id": client_id,
            "layers": info["layers"],
            "total_params": info["total_params"],
            "warning": warning,
            "round": self.state["round"],
        }

    def get_weights(self, name: str) -> dict | None:
        with self._lock:
            w = self.weights.get(name)
        if w is None:
            w = self._load_from_disk(name)
            if w is not None:
                with self._lock:
                    self.weights[name] = w
        return w

    def delete_weights(self, name: str) -> dict:
        with self._lock:
            existed = name in self.weights
            self.weights.pop(name, None)
            self.state["active_clients"].discard(name)
        try:
            os.remove(self._path(name))
            existed = True
        except OSError:
            pass
        return {"success": existed}

    # -- aggregation (federated.py:577-700) ------------------------------------
    def aggregate(
        self,
        client_ids: list | None = None,
        proportional: bool = False,
        min_clients: int | None = None,
    ) -> dict:
        min_clients = self.min_clients if min_clients is None else min_clients
        with self._lock:
            self.state["status"] = "aggregating"
            try:
                clients = client_ids or sorted(self.state["active_clients"])
                clients = [c for c in clients if c in self.weights and not c.startswith("global_model")]
                if len(clients) < min_clients:
                    raise FedAvgError(
                        f"need at least {min_clients} clients, have {len(clients)}"
                    )
                updates = {c: self.weights[c] for c in clients}
                check_layer_consistency(updates)
                contributions = {
                    c: self.client_registry.get(c, {}).get("contribution_count", 0)
                    for c in clients
                }
                w = resolve_weights(clients, contributions, proportional)
                result = self._combine(updates, w)

                version = self.state["version"] + 1
                name = f"global_model_v{version}"
                self.weights[name] = result
                self._persist(name, result)
                self.state["version"] = version
                self.state["round"] += 1
                entry = {
                    "round": self.state["round"],
                    "version": version,
                    "clients": clients,
                    "weights": {c: round(w[c], 6) for c in clients},
                    "proportional": proportional,
                    "timestamp": datetime.now().isoformat(),
                    "layer_count": len(result),
                    "backend": self._backend_name(len(clients)),
                }
                self.aggregation_history.append(entry)
                del self.aggregation_history[: -self.history_limit]
                audit_event("fl_aggregate", entry)
                return {"success": True, **entry, "global_model": name}
            finally:
                self.state["status"] = "idle"

    def _backend_name(self, k: int) -> str:
        if self.mesh is not None and self.mesh.devices.size > 1:
            return f"mesh_psum[{self.mesh.devices.size}]"
        return "host"

    def _combine(self, updates: dict, weights: dict) -> dict:
        """Over this process's mesh positions when it has several; the host
        numpy combine otherwise: the same math (tested against each
        other)."""
        mesh = self._local_mesh()
        if mesh is None or mesh.devices.size <= 1:
            return fedavg_combine(updates, weights)
        clients = list(updates.keys())
        names = sorted(updates[clients[0]].keys())
        stacked = {n: np.stack([np.asarray(updates[c][n], np.float32) for c in clients])
                   for n in names}
        wvec = np.asarray([weights[c] for c in clients], np.float32)
        stacked, wvec = pad_clients(stacked, wvec, mesh.shape[DATA_AXIS])
        out = fedavg_sharded(mesh, stacked, wvec)
        return {n: out[n].cpu().numpy().astype(np.float64) for n in names}

    def _local_mesh(self):
        """The mesh of the FL combine, this process's positions only: an
        aggregate comes from one process's HTTP handler, and a process mesh
        would enter a collective the other processes never join. A process
        mesh holds one position a process, so it combines on the host; across
        processes FL stays what the reference makes it, clients exchanging
        weights over HTTP."""
        if self.mesh is None or self.mesh.is_process_mesh:
            return None
        return self.mesh

    # -- rounds (federated.py:1086-1136) ---------------------------------------
    def start_round(self) -> dict:
        with self._lock:
            self.state["round"] += 1
            self.state["status"] = "collecting"
            self.state["active_clients"] = set()
            self.state["round_started_at"] = datetime.now().isoformat()
            return self.round_status()

    def round_status(self) -> dict:
        with self._lock:
            return {
                "round": self.state["round"],
                "status": self.state["status"],
                "active_clients": sorted(self.state["active_clients"]),
                "started_at": self.state["round_started_at"],
                "min_clients": self.min_clients,
            }

    # -- introspection ----------------------------------------------------------
    def status(self) -> dict:
        with self._lock:
            return {
                "round": self.state["round"],
                "version": self.state["version"],
                "status": self.state["status"],
                "active_clients": sorted(self.state["active_clients"]),
                "registered_clients": len(self.client_registry),
                "stored_weight_sets": sorted(self.weights.keys()),
                "latest_global_model": f"global_model_v{self.state['version']}"
                if self.state["version"] > 0
                else None,
            }

    def get_global_model(self, version: int | None = None) -> tuple[str, dict] | None:
        with self._lock:
            v = self.state["version"] if version is None else version
        if v <= 0:
            return None
        name = f"global_model_v{v}"
        w = self.get_weights(name)
        return (name, w) if w is not None else None

    def get_history(self) -> list:
        with self._lock:
            return list(self.aggregation_history)

    def get_client_metrics(self, client_id: str | None = None) -> dict:
        with self._lock:
            if client_id:
                return dict(self.client_metrics.get(client_id, {}))
            return {c: dict(m) for c, m in self.client_metrics.items()}

    def get_stats(self) -> dict:
        with self._lock:
            sizes = [m.get("avg_weights_size", 0) for m in self.client_metrics.values()]
            return {
                "round": self.state["round"],
                "version": self.state["version"],
                "registered_clients": len(self.client_registry),
                "active_clients": len(self.state["active_clients"]),
                "aggregations": len(self.aggregation_history),
                "avg_update_params": round(sum(sizes) / len(sizes), 1) if sizes else 0,
                "weights_dir": self._dir,
                "aggregation_backend": "host",
            }

    def validate_weights(self, weights: dict) -> dict:
        """Dry-run structure analyzer (federated.py:1142-1181)."""
        try:
            info = validate_client_update(weights)
            return {"valid": True, **info}
        except FedAvgError as e:
            return {"valid": False, "error": str(e)}

    def reset(self) -> dict:
        with self._lock:
            n = len(self.weights)
            self.weights.clear()
            self.client_registry.clear()
            self.client_metrics.clear()
            self.aggregation_history.clear()
            self.state.update(
                {"round": 0, "version": 0, "status": "idle", "active_clients": set()}
            )
        try:
            for f in os.listdir(self._dir):
                if f.endswith(".json"):
                    os.remove(os.path.join(self._dir, f))
        except OSError:
            pass
        audit_event("fl_reset", {"cleared_weight_sets": n})
        return {"success": True, "cleared_weight_sets": n}

    def export(self) -> dict:
        with self._lock:
            return {
                "state": self.status(),
                "clients": self.list_clients(),
                "history": list(self.aggregation_history),
                "exported_at": datetime.now().isoformat(),
            }

    def health_check(self) -> dict:
        return {
            "status": "healthy",
            "round": self.state["round"],
            "version": self.state["version"],
            "weights_dir_writable": os.access(self._dir, os.W_OK),
        }
