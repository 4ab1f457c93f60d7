"""Pluggable state-store transports for the durable control plane.

A copy of ``repro/core/engine/durable/store.py``, with its imports in
``repro_torch.core``.

The ACAI paper backs its execution engine with Redis: the job queue, the
registry and the event stream all live in a store that outlives the
engine process. This module is that seam, shrunk to the two Redis
primitives the engine actually needs:

* **streams** — append-only sequences of JSON records
  (``XADD``/``XRANGE``): the write-ahead journal and the event log.
* **keys** — whole-document reads/writes (``SET``/``GET``): snapshots.

``MemoryStore`` keeps everything in process (tests, and engines that opt
out of durability pay nothing). ``FileStore`` is the default durable
backend: each stream is a ``<name>.jsonl`` file appended line-at-a-time
and flushed per record, each key a ``<name>.json`` written atomically via
tmp + rename. A real Redis/SQL transport implements the same five
methods and nothing above this layer changes.

Crash semantics of ``FileStore``: a ``kill -9`` can tear at most the
final journal line (the OS page cache still lands buffered writes of a
dead process on disk; only power loss needs ``fsync=True``). Readers
therefore skip a trailing unparseable line instead of failing — the
torn record was never acknowledged, so dropping it is correct.
"""
from __future__ import annotations

import io
import json
import os
import threading
from pathlib import Path
from typing import Any, Optional


class StateStore:
    """Transport interface: streams of JSON records + JSON key documents."""

    def append(self, stream: str, record: dict) -> None:
        raise NotImplementedError

    def read(self, stream: str) -> list[dict]:
        raise NotImplementedError

    def truncate(self, stream: str) -> None:
        """Drop every record in the stream (journal compaction)."""
        raise NotImplementedError

    def put(self, key: str, obj: Any) -> None:
        raise NotImplementedError

    def get(self, key: str) -> Optional[Any]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError


class MemoryStore(StateStore):
    """In-process backend: durability machinery without the disk (tests,
    and the cheapest way to exercise journal/recovery logic)."""

    def __init__(self):
        self._streams: dict[str, list[dict]] = {}
        self._keys: dict[str, Any] = {}
        self._lock = threading.Lock()

    def append(self, stream: str, record: dict) -> None:
        # round-trip through JSON so Memory and File backends accept (and
        # reject) exactly the same records — tests on Memory stay honest
        line = json.dumps(record, default=str)
        with self._lock:
            self._streams.setdefault(stream, []).append(json.loads(line))

    def read(self, stream: str) -> list[dict]:
        with self._lock:
            return list(self._streams.get(stream, ()))

    def truncate(self, stream: str) -> None:
        with self._lock:
            self._streams[stream] = []

    def put(self, key: str, obj: Any) -> None:
        line = json.dumps(obj, default=str)
        with self._lock:
            self._keys[key] = json.loads(line)

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            return self._keys.get(key)

    def delete(self, key: str) -> None:
        with self._lock:
            self._keys.pop(key, None)


class FileStore(StateStore):
    """Directory-backed durable store (the default Redis stand-in).

    ``fsync=True`` additionally fsyncs every append/put — survives power
    loss, not just process death — at a large per-record cost; the
    default relies on the page cache outliving a SIGKILL.
    """

    def __init__(self, root: str | Path, *, fsync: bool = False):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.fsync = fsync
        self._handles: dict[str, io.TextIOWrapper] = {}
        self._lock = threading.Lock()

    def _stream_path(self, stream: str) -> Path:
        return self.root / f"{stream}.jsonl"

    def _key_path(self, key: str) -> Path:
        return self.root / f"{key}.json"

    def append(self, stream: str, record: dict) -> None:
        line = json.dumps(record, default=str)
        with self._lock:
            fh = self._handles.get(stream)
            if fh is None or fh.closed:
                fh = self._stream_path(stream).open("a", encoding="utf-8")
                self._handles[stream] = fh
            fh.write(line + "\n")
            fh.flush()
            if self.fsync:
                os.fsync(fh.fileno())

    def read(self, stream: str) -> list[dict]:
        path = self._stream_path(stream)
        if not path.exists():
            return []
        out: list[dict] = []
        with self._lock:
            lines = path.read_text(encoding="utf-8").splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    break       # torn tail from a crash mid-append: the
                                # record was never acknowledged — drop it
                raise
        return out

    def truncate(self, stream: str) -> None:
        with self._lock:
            fh = self._handles.pop(stream, None)
            if fh is not None and not fh.closed:
                fh.close()
            path = self._stream_path(stream)
            tmp = path.with_suffix(".jsonl.tmp")
            tmp.write_text("", encoding="utf-8")
            os.replace(tmp, path)

    def put(self, key: str, obj: Any) -> None:
        path = self._key_path(key)
        tmp = path.with_suffix(".json.tmp")
        data = json.dumps(obj, default=str)
        with self._lock:
            tmp.write_text(data, encoding="utf-8")
            if self.fsync:
                fd = os.open(tmp, os.O_RDONLY)
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)
            # atomic: a crash leaves either the old snapshot or the new
            # one, never a half-written file
            os.replace(tmp, path)

    def get(self, key: str) -> Optional[Any]:
        path = self._key_path(key)
        if not path.exists():
            return None
        try:
            return json.loads(path.read_text(encoding="utf-8"))
        except json.JSONDecodeError:
            return None     # interrupted before the first snapshot's
                            # rename landed: recover from the journal alone

    def delete(self, key: str) -> None:
        path = self._key_path(key)
        if path.exists():
            path.unlink()

    def close(self) -> None:
        with self._lock:
            for fh in self._handles.values():
                if not fh.closed:
                    fh.close()
            self._handles.clear()
