"""Versioned object storage (ACAI §3.2.1, §4.4.1–4.4.3); a copy of
``repro/core/datalake/storage.py``, whose on-disk format (``catalog.json``,
``blobs/<sha256>``) it keeps, so either package reads the other's files.

The paper stores each user file as an S3 object and keeps the hierarchy +
version table in MySQL; we keep the same split locally: payload bytes live in
a content-addressed blob directory (the "S3"), while the hierarchy, version
table and upload sessions are a JSON-persisted catalog (the "MySQL").
Semantics preserved:

  * every version is immutable; version numbers are sequential with no gaps;
  * the latest version is used when none is specified; ``name@v`` pins one;
  * batch uploads are transactional **upload sessions** (pending ->
    committed | aborted), crash-safe via persisted session state;
  * uploads/downloads go "directly to S3": callers receive a blob path
    ("presigned URL") and the server only records completion events.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from pathlib import Path
from typing import Iterable, Optional


class DataLakeError(RuntimeError):
    pass


@dataclasses.dataclass
class FileVersion:
    path: str
    version: int
    blob: str          # content hash
    size: int
    created_at: float
    creator: str = ""


def parse_ref(ref: str) -> tuple[str, Optional[int]]:
    """'/data/train.json@2' -> ('/data/train.json', 2)."""
    if "@" in ref:
        path, v = ref.rsplit("@", 1)
        return path, int(v)
    return ref, None


class Storage:
    """One project's versioned file store."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.blob_dir = self.root / "blobs"
        self.blob_dir.mkdir(parents=True, exist_ok=True)
        self._catalog_path = self.root / "catalog.json"
        self._lock = threading.Lock()   # the paper's server-side lock
        self._files: dict[str, list[FileVersion]] = {}
        self._sessions: dict[str, dict] = {}
        self._session_ctr = 0
        self._load()

    # -- persistence ---------------------------------------------------
    def _load(self) -> None:
        if self._catalog_path.exists():
            raw = json.loads(self._catalog_path.read_text())
            self._files = {p: [FileVersion(**v) for v in vs]
                           for p, vs in raw["files"].items()}
            self._sessions = raw["sessions"]
            self._session_ctr = raw["session_ctr"]

    def _save(self) -> None:
        raw = {"files": {p: [dataclasses.asdict(v) for v in vs]
                         for p, vs in self._files.items()},
               "sessions": self._sessions,
               "session_ctr": self._session_ctr}
        tmp = self._catalog_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(raw))
        os.replace(tmp, self._catalog_path)

    # -- blobs ("S3") --------------------------------------------------
    def _put_blob(self, data) -> str:
        """Store a bytes-like object (bytes, or a memoryview of a buffer, so
        a large payload is not copied into a bytes first) under its hash."""
        h = hashlib.sha256(data).hexdigest()
        p = self.blob_dir / h
        if not p.exists():
            tmp = p.with_suffix(".tmp-%d" % os.getpid())
            tmp.write_bytes(data)
            os.replace(tmp, p)
        return h

    def _get_blob(self, blob: str) -> bytes:
        p = self.blob_dir / blob
        if not p.exists():
            raise DataLakeError(f"missing blob {blob}")
        return p.read_bytes()

    def blob_path(self, path: str, version: Optional[int] = None) -> Path:
        """'presigned URL': direct filesystem path to the payload."""
        fv = self.resolve(path, version)
        return self.blob_dir / fv.blob

    # -- single-file API -----------------------------------------------
    def upload(self, path: str, data: bytes, creator: str = "") -> FileVersion:
        sid = self.begin_session([path], creator)
        self.session_put(sid, path, data)
        return self.commit_session(sid)[0]

    def download(self, ref: str) -> bytes:
        path, version = parse_ref(ref)
        return self._get_blob(self.resolve(path, version).blob)

    def resolve(self, path: str, version: Optional[int] = None) -> FileVersion:
        vs = self._files.get(path)
        if not vs:
            raise DataLakeError(f"no such file {path}")
        if version is None:
            return vs[-1]
        for v in vs:
            if v.version == version:
                return v
        raise DataLakeError(f"no version {version} of {path}")

    def exists(self, path: str) -> bool:
        return path in self._files

    def list_files(self, prefix: str = "/") -> list[str]:
        return sorted(p for p in self._files if p.startswith(prefix))

    def versions(self, path: str) -> list[int]:
        return [v.version for v in self._files.get(path, [])]

    # -- upload sessions (transactional batch upload, §4.4.3) -----------
    def begin_session(self, paths: Iterable[str], creator: str = "") -> str:
        with self._lock:
            self._session_ctr += 1
            sid = f"session-{self._session_ctr}"
            self._sessions[sid] = {
                "state": "pending", "creator": creator,
                "files": {p: None for p in paths},   # path -> blob once uploaded
                "started_at": time.time(),
            }
            self._save()
            return sid

    def session_put(self, sid: str, path: str, data) -> None:
        # distinct destination per file: content-addressing guarantees
        # asynchronous uploads never overwrite each other's blobs — but the
        # catalog save must still be serialized across concurrent agents
        blob = self._put_blob(data)
        with self._lock:
            sess = self._session(sid, "pending")
            if path not in sess["files"]:
                raise DataLakeError(f"{path} not declared in session {sid}")
            sess["files"][path] = [blob, memoryview(data).nbytes]
            self._save()

    def commit_session(self, sid: str) -> list[FileVersion]:
        """Allocate sequential version numbers; only fully-uploaded sessions
        commit, so failed uploads never occupy version numbers."""
        with self._lock:
            sess = self._session(sid, "pending")
            missing = [p for p, b in sess["files"].items() if b is None]
            if missing:
                raise DataLakeError(
                    f"session {sid} incomplete, missing {missing}")
            out = []
            now = time.time()
            for path, (blob, size) in sess["files"].items():
                vs = self._files.setdefault(path, [])
                nxt = vs[-1].version + 1 if vs else 1
                fv = FileVersion(path=path, version=nxt, blob=blob,
                                 size=size, created_at=now,
                                 creator=sess["creator"])
                vs.append(fv)
                out.append(fv)
            sess["state"] = "committed"
            self._save()
            return out

    def abort_session(self, sid: str) -> None:
        with self._lock:
            sess = self._session(sid, "pending")
            sess["state"] = "aborted"
            sess["files"] = {}
            self._save()

    def session_state(self, sid: str) -> str:
        if sid not in self._sessions:
            raise DataLakeError(f"no session {sid}")
        return self._sessions[sid]["state"]

    def _session(self, sid: str, want_state: str) -> dict:
        sess = self._sessions.get(sid)
        if sess is None:
            raise DataLakeError(f"no session {sid}")
        if sess["state"] != want_state:
            raise DataLakeError(
                f"session {sid} is {sess['state']}, wanted {want_state}")
        return sess
