"""Metadata store (ACAI §3.2.3, §4.5.1); a copy of
``repro/core/datalake/metadata.py`` over the same ``metadata.json``.

Key-value attributes on files, file sets and jobs, with the paper's query
surface: equality match, range queries (e.g. time ranges, `precision>0.5`),
and max/min queries. The paper hosts this on MongoDB with per-key indexes;
we keep an in-process document store with the same behaviour — per-key
inverted/sorted indexes, JSON persistence, predefined indexed keys that
users may update (e.g. every job has ``training_loss``).
"""
from __future__ import annotations

import bisect
import json
import threading
import time
from pathlib import Path
from typing import Any, Iterable, Optional

PREDEFINED_KEYS = ("creator", "create_time", "kind", "training_loss",
                   "precision", "model")


class MetadataStore:
    def __init__(self, root: str | Path):
        Path(root).mkdir(parents=True, exist_ok=True)
        self._path = Path(root) / "metadata.json"
        # job agents on ThreadPoolRunner workers put() concurrently
        self._lock = threading.RLock()
        self._docs: dict[str, dict[str, Any]] = {}
        # key -> sorted [(value, artifact_id)]
        self._index: dict[str, list[tuple[Any, str]]] = {}
        if self._path.exists():
            self._docs = json.loads(self._path.read_text())
            for aid, doc in self._docs.items():
                for k, v in doc.items():
                    self._index_add(k, v, aid)

    def _save(self) -> None:
        self._path.write_text(json.dumps(self._docs))

    # ------------------------------------------------------------------
    def _index_add(self, key: str, value: Any, aid: str) -> None:
        if value is None:
            return
        idx = self._index.setdefault(key, [])
        bisect.insort(idx, (value, aid))

    def _index_remove(self, key: str, value: Any, aid: str) -> None:
        idx = self._index.get(key, [])
        i = bisect.bisect_left(idx, (value, aid))
        if i < len(idx) and idx[i] == (value, aid):
            idx.pop(i)

    # ------------------------------------------------------------------
    def register(self, artifact_id: str, kind: str, **attrs: Any) -> None:
        """Called at file upload / fileset creation / job completion."""
        doc = {k: None for k in PREDEFINED_KEYS}
        doc.update({"kind": kind, "create_time": time.time()})
        doc.update(attrs)
        self.put(artifact_id, **doc)

    def put(self, artifact_id: str, **attrs: Any) -> None:
        with self._lock:
            doc = self._docs.setdefault(artifact_id, {})
            for k, v in attrs.items():
                if k in doc and doc[k] is not None:
                    self._index_remove(k, doc[k], artifact_id)
                doc[k] = v
                self._index_add(k, v, artifact_id)
            self._save()

    def tag(self, artifact_id: str, tag: str) -> None:
        with self._lock:
            doc = self._docs.setdefault(artifact_id, {})
            tags = doc.setdefault("tags", [])
            if tag not in tags:
                tags.append(tag)
            self._save()

    def get(self, artifact_id: str) -> dict[str, Any]:
        return dict(self._docs.get(artifact_id, {}))

    # -- queries ---------------------------------------------------------
    def find(self, *, tags: Optional[Iterable[str]] = None,
             **conditions: Any) -> list[str]:
        """Equality + range query.

        Conditions: ``key=value`` (equality), ``key=("range", lo, hi)``,
        ``key=(">", x)``, ``key=("<", x)``. Returns matching artifact ids.
        """
        result: Optional[set[str]] = None
        for key, cond in conditions.items():
            idx = self._index.get(key, [])
            if isinstance(cond, tuple):
                op = cond[0]
                if op == "range":
                    lo, hi = cond[1], cond[2]
                elif op == ">":
                    lo, hi = cond[1], float("inf")
                elif op == "<":
                    lo, hi = float("-inf"), cond[1]
                else:
                    raise ValueError(f"bad condition {cond}")
                i = bisect.bisect_right(idx, (lo, "￿"))
                j = bisect.bisect_left(idx, (hi, ""))
                hits = {aid for _, aid in idx[i:j]}
            else:
                i = bisect.bisect_left(idx, (cond, ""))
                j = bisect.bisect_right(idx, (cond, "￿"))
                hits = {aid for _, aid in idx[i:j]}
            result = hits if result is None else (result & hits)
        if tags:
            tagged = {aid for aid, doc in self._docs.items()
                      if set(tags) <= set(doc.get("tags", []))}
            result = tagged if result is None else (result & tagged)
        if result is None:
            result = set(self._docs)
        return sorted(result)

    def find_max(self, key: str, **conditions: Any) -> Optional[str]:
        ids = set(self.find(**conditions))
        idx = self._index.get(key, [])
        for _value, aid in reversed(idx):
            if aid in ids:
                return aid
        return None

    def find_min(self, key: str, **conditions: Any) -> Optional[str]:
        ids = set(self.find(**conditions))
        for _value, aid in self._index.get(key, []):
            if aid in ids:
                return aid
        return None
