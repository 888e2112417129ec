"""Embedded document store with the pymongo collection surface.

The reference hard-requires a live MongoDB at import time (``backend/app/
utils/db.py:155`` — the app cannot even import without it; SURVEY.md section 1
flags this as an inversion to fix). Here storage is pluggable:

* default: this embedded, thread-safe, JSON-on-disk store (zero deps),
* ``MONGO_URI`` set + pymongo importable: the real thing, same call sites.

Implements exactly the subset the platform uses: insert_one, find / find_one
(dict equality + $in / $gte / $lte / $gt / $lt / $ne filters), update_one with
upsert, delete_one/delete_many, count_documents, create_index (no-op metadata),
aggregate (only the $match/$sort/$limit stages the reference's tracking-history
loader builds, ``db.py:563-604``), distinct, and replace_one — intentionally
small, documented, and tested.
"""

from __future__ import annotations

import json
import os
import threading
import copy
import uuid
from typing import Any, Iterable


def _sort_key(v):
    """Total order over mixed/missing values (Mongo sorts by type; one doc
    missing the sort field must not TypeError the whole query): None first,
    then numbers, then everything else by string form."""
    if v is None:
        return (0, 0.0, "")
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return (2, 0.0, str(v))
    return (1, float(v), "")


def _matches(doc: dict, query: dict) -> bool:
    for key, cond in query.items():
        val = doc.get(key)
        if isinstance(cond, dict):
            for op, rhs in cond.items():
                if op == "$in":
                    if val not in rhs:
                        return False
                elif op == "$nin":
                    if val in rhs:
                        return False
                elif op == "$gte":
                    if val is None or not val >= rhs:
                        return False
                elif op == "$lte":
                    if val is None or not val <= rhs:
                        return False
                elif op == "$gt":
                    if val is None or not val > rhs:
                        return False
                elif op == "$lt":
                    if val is None or not val < rhs:
                        return False
                elif op == "$ne":
                    if val == rhs:
                        return False
                elif op == "$exists":
                    if bool(key in doc) != bool(rhs):
                        return False
                else:
                    raise ValueError(f"unsupported operator {op}")
        elif val != cond:
            return False
    return True


class _Result:
    def __init__(self, **kw):
        self.__dict__.update(kw)


class Collection:
    def __init__(self, name: str, path: str | None, lock: threading.RLock):
        self.name = name
        self._path = path
        self._lock = lock
        self._docs: dict[str, dict] = {}
        self._indexes: list = []
        if path and os.path.exists(path):
            self._load()

    # -- persistence ---------------------------------------------------------
    def _load(self):
        try:
            with open(self._path, "r") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        doc = json.loads(line)
                        self._docs[doc["_id"]] = doc
                    except (json.JSONDecodeError, KeyError, TypeError):
                        continue  # skip a torn/corrupt line, keep the rest
        except OSError:
            self._docs = {}

    def _flush(self):
        if not self._path:
            return
        tmp = f"{self._path}.{os.getpid()}.tmp"
        os.makedirs(os.path.dirname(self._path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            for doc in self._docs.values():
                f.write(json.dumps(doc, default=str) + "\n")
        os.replace(tmp, self._path)

    def _append(self, docs: list):
        """JSONL append for inserts: _flush rewrites the WHOLE collection
        per write — quadratic over time for the unbounded hot-path
        'tracking' collection (each scan-loop detection rewrote every doc
        ever stored, under the lock). Updates/deletes still _flush."""
        if not self._path:
            return
        os.makedirs(os.path.dirname(self._path) or ".", exist_ok=True)
        with open(self._path, "a") as f:
            for doc in docs:
                f.write(json.dumps(doc, default=str) + "\n")

    # -- pymongo surface ------------------------------------------------------
    def insert_one(self, doc: dict):
        with self._lock:
            doc = copy.deepcopy(dict(doc))  # no aliasing with caller state
            doc.setdefault("_id", uuid.uuid4().hex)
            self._docs[doc["_id"]] = doc
            self._append([doc])
            return _Result(inserted_id=doc["_id"], acknowledged=True)

    def insert_many(self, docs: Iterable[dict]):
        ids = []
        added = []
        with self._lock:
            for doc in docs:
                doc = copy.deepcopy(dict(doc))
                doc.setdefault("_id", uuid.uuid4().hex)
                self._docs[doc["_id"]] = doc
                ids.append(doc["_id"])
                added.append(doc)
            self._append(added)
        return _Result(inserted_ids=ids, acknowledged=True)

    def find_one(self, query: dict | None = None, projection=None):
        with self._lock:
            for doc in self._docs.values():
                if _matches(doc, query or {}):
                    return self._project(copy.deepcopy(doc), projection)
        return None

    def find(self, query: dict | None = None, projection=None):
        with self._lock:
            docs = [
                self._project(copy.deepcopy(d), projection)
                for d in self._docs.values()
                if _matches(d, query or {})
            ]
        return Cursor(docs)

    @staticmethod
    def _project(doc, projection):
        if not projection:
            return doc
        include = {k for k, v in projection.items() if v}
        exclude = {k for k, v in projection.items() if not v}
        if include:
            return {k: v for k, v in doc.items() if k in include or k == "_id"} if "_id" not in exclude else {
                k: v for k, v in doc.items() if k in include
            }
        return {k: v for k, v in doc.items() if k not in exclude}

    def update_one(self, query: dict, update: dict, upsert: bool = False):
        with self._lock:
            for doc in self._docs.values():
                if _matches(doc, query):
                    self._apply(doc, update)
                    self._flush()
                    return _Result(matched_count=1, modified_count=1, upserted_id=None)
            if upsert:
                base = {k: v for k, v in query.items() if not isinstance(v, dict)}
                doc = dict(base)
                doc["_id"] = uuid.uuid4().hex
                self._apply(doc, update)
                self._docs[doc["_id"]] = doc
                self._flush()
                return _Result(matched_count=0, modified_count=0, upserted_id=doc["_id"])
            return _Result(matched_count=0, modified_count=0, upserted_id=None)

    def replace_one(self, query: dict, replacement: dict, upsert: bool = False):
        with self._lock:
            for _id, doc in self._docs.items():
                if _matches(doc, query):
                    new = dict(replacement)
                    new["_id"] = _id
                    self._docs[_id] = new
                    self._flush()
                    return _Result(matched_count=1, modified_count=1, upserted_id=None)
            if upsert:
                new = dict(replacement)
                new.setdefault("_id", uuid.uuid4().hex)
                self._docs[new["_id"]] = new
                self._flush()
                return _Result(matched_count=0, modified_count=0, upserted_id=new["_id"])
            return _Result(matched_count=0, modified_count=0, upserted_id=None)

    @staticmethod
    def _apply(doc: dict, update: dict):
        for op, fields in update.items():
            if op == "$set":
                doc.update(fields)
            elif op == "$inc":
                for k, v in fields.items():
                    doc[k] = doc.get(k, 0) + v
            elif op == "$push":
                for k, v in fields.items():
                    doc.setdefault(k, []).append(v)
            elif op == "$unset":
                for k in fields:
                    doc.pop(k, None)
            else:
                raise ValueError(f"unsupported update operator {op}")

    def delete_one(self, query: dict):
        with self._lock:
            for _id, doc in list(self._docs.items()):
                if _matches(doc, query):
                    del self._docs[_id]
                    self._flush()
                    return _Result(deleted_count=1)
            return _Result(deleted_count=0)

    def delete_many(self, query: dict):
        with self._lock:
            ids = [i for i, d in self._docs.items() if _matches(d, query or {})]
            for i in ids:
                del self._docs[i]
            if ids:
                self._flush()
            return _Result(deleted_count=len(ids))

    def count_documents(self, query: dict | None = None) -> int:
        with self._lock:
            return sum(1 for d in self._docs.values() if _matches(d, query or {}))

    def distinct(self, key: str, query: dict | None = None) -> list:
        with self._lock:
            vals = {
                d.get(key)
                for d in self._docs.values()
                if _matches(d, query or {}) and key in d
            }
        return sorted(vals, key=str)

    def create_index(self, keys, **kwargs):
        self._indexes.append((keys, kwargs))
        return str(keys)

    def aggregate(self, stages: list):
        docs = list(self.find({}))
        for stage in stages:
            if "$match" in stage:
                docs = [d for d in docs if _matches(d, stage["$match"])]
            elif "$sort" in stage:
                for key, direction in reversed(list(stage["$sort"].items())):
                    docs.sort(
                        key=lambda d: _sort_key(d.get(key)),
                        reverse=direction < 0,
                    )
            elif "$limit" in stage:
                docs = docs[: stage["$limit"]]
            else:
                raise ValueError(f"unsupported aggregate stage {list(stage)}")
        return iter(docs)


class Cursor:
    def __init__(self, docs: list):
        self._docs = docs

    def sort(self, key, direction: int = 1):
        if isinstance(key, list):
            for k, d in reversed(key):
                self._docs.sort(
                    key=lambda doc: _sort_key(doc.get(k)), reverse=d < 0
                )
        else:
            self._docs.sort(
                key=lambda doc: _sort_key(doc.get(key)), reverse=direction < 0
            )
        return self

    def limit(self, n: int):
        self._docs = self._docs[:n]
        return self

    def skip(self, n: int):
        self._docs = self._docs[n:]
        return self

    def __iter__(self):
        return iter(self._docs)

    def __len__(self):
        return len(self._docs)


class DocStore:
    """A database of named collections, JSON-lines persisted per collection."""

    def __init__(self, data_dir: str | None = None):
        self._dir = data_dir
        self._lock = threading.RLock()
        self._collections: dict[str, Collection] = {}

    def __getitem__(self, name: str) -> Collection:
        with self._lock:
            if name not in self._collections:
                path = (
                    os.path.join(self._dir, f"{name}.jsonl") if self._dir else None
                )
                self._collections[name] = Collection(name, path, threading.RLock())
            return self._collections[name]

    def __getattr__(self, name: str) -> Collection:
        if name.startswith("_"):
            raise AttributeError(name)
        return self[name]

    def list_collection_names(self):
        with self._lock:
            return list(self._collections.keys())

    def ping(self) -> bool:
        return True


def connect(mongo_uri: str = "", data_dir: str | None = None,
            db_name: str = "", retries: int = 1, backoff: float = 2.0):
    """Return (db, backend_name): real Mongo when configured, embedded store
    otherwise. Never raises at import time (fixing db.py:155).

    db_name / retries / backoff: MONGO_DB_NAME / MONGO_CONNECT_RETRIES /
    MONGO_CONNECT_BACKOFF (reference db.py:84-124: ping + retries with
    backoff*n sleep between attempts)."""
    if mongo_uri:
        import time as _time

        try:
            import pymongo  # outside the retry loop: an ImportError can
        except ImportError:  # never succeed on retry — fall back instantly
            pymongo = None
        for attempt in range(max(retries, 1) if pymongo else 0):
            client = None
            try:
                client = pymongo.MongoClient(
                    mongo_uri, serverSelectionTimeoutMS=3000)
                client.admin.command("ping")
                return client.get_default_database(db_name or "frp"), "mongodb"
            except Exception:
                if client is not None:
                    try:
                        client.close()
                    except Exception:
                        pass
                if attempt + 1 < max(retries, 1):
                    _time.sleep(backoff * (attempt + 1))
    return DocStore(data_dir), "embedded"
