"""File sets (ACAI §3.2.2): versioned named lists of (file, version) refs;
a copy of ``repro/core/datalake/fileset.py`` over the same
``filesets.json``.

Spec grammar supported by ``FileSetManager.create``:
  '/data/train.json'        latest version of a file
  '/data/train.json@2'      pinned file version
  '/@HotpotQA'              every file of the latest version of set HotpotQA
  '/@HotpotQA:1'            ... of set version 1
  '/validation/@HotpotQA'   subset: files under a directory within a set
  '/data/train.json@HotpotQA:1'  the version of that file referenced by the set

Creation from other sets records a fileset-creation dependency edge in the
provenance graph (merge / update / subset — §3.2.2 examples).
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Optional, TYPE_CHECKING

from repro_torch.core.datalake.storage import DataLakeError, Storage

if TYPE_CHECKING:
    from repro_torch.core.datalake.provenance import ProvenanceGraph


@dataclasses.dataclass
class FileSetVersion:
    name: str
    version: int
    files: dict[str, int]         # path -> file version
    created_at: float
    creator: str = ""

    @property
    def ref(self) -> str:
        return f"{self.name}:{self.version}"


def parse_set_ref(ref: str) -> tuple[str, Optional[int]]:
    """'HotpotQA:1' -> ('HotpotQA', 1); 'HotpotQA' -> ('HotpotQA', None)."""
    if ":" in ref:
        name, v = ref.rsplit(":", 1)
        return name, int(v)
    return ref, None


class FileSetManager:
    def __init__(self, storage: Storage,
                 provenance: "Optional[ProvenanceGraph]" = None):
        self.storage = storage
        self.provenance = provenance
        self._path = storage.root / "filesets.json"
        # job agents on ThreadPoolRunner workers create sets concurrently
        self._lock = threading.RLock()
        self._sets: dict[str, list[FileSetVersion]] = {}
        if self._path.exists():
            raw = json.loads(self._path.read_text())
            self._sets = {n: [FileSetVersion(**v) for v in vs]
                          for n, vs in raw.items()}

    def _save(self) -> None:
        self._path.write_text(json.dumps(
            {n: [dataclasses.asdict(v) for v in vs]
             for n, vs in self._sets.items()}))

    # ------------------------------------------------------------------
    def resolve(self, ref: str) -> FileSetVersion:
        name, version = parse_set_ref(ref)
        vs = self._sets.get(name)
        if not vs:
            raise DataLakeError(f"no such file set {name}")
        if version is None:
            return vs[-1]
        for v in vs:
            if v.version == version:
                return v
        raise DataLakeError(f"no version {version} of file set {name}")

    def exists(self, name: str) -> bool:
        return name in self._sets

    def list_sets(self) -> list[str]:
        return sorted(self._sets)

    # ------------------------------------------------------------------
    def _expand_spec(self, spec: str) -> tuple[dict[str, int], list[str]]:
        """Expand one spec string -> ({path: version}, [source fileset refs])."""
        deps: list[str] = []
        if "@" in spec:
            prefix, ref = spec.split("@", 1)
            # '@Set' or '@Set:1' possibly with a path prefix filter
            if self.exists(parse_set_ref(ref)[0]):
                fsv = self.resolve(ref)
                deps.append(fsv.ref)
                if prefix in ("", "/"):
                    return dict(fsv.files), deps
                # subset filter: '/validation/@Set' or a single file
                sub = {p: v for p, v in fsv.files.items()
                       if p.startswith(prefix) or p == prefix.rstrip("/")}
                if not sub:
                    raise DataLakeError(
                        f"{prefix!r} matches nothing in file set {ref}")
                return sub, deps
            # plain '@<int>' version pin
            path, version = prefix, int(ref)
            fv = self.storage.resolve(path, version)
            return {fv.path: fv.version}, deps
        fv = self.storage.resolve(spec)
        return {fv.path: fv.version}, deps

    def create(self, name: str, specs: list[str],
               creator: str = "") -> FileSetVersion:
        """Create (or new-version) a file set from spec strings. Later specs
        override earlier ones for the same path (the paper's update example).
        A file set cannot contain two versions of the same file by
        construction. Dependencies to source sets are recorded."""
        with self._lock:
            files: dict[str, int] = {}
            deps: list[str] = []
            for spec in specs:
                got, d = self._expand_spec(spec)
                files.update(got)
                deps.extend(d)
            vs = self._sets.setdefault(name, [])
            prev = vs[-1] if vs else None
            fsv = FileSetVersion(name=name, version=(prev.version + 1 if prev
                                                     else 1),
                                 files=files, created_at=time.time(),
                                 creator=creator)
            vs.append(fsv)
            self._save()
        if self.provenance is not None:
            self.provenance.add_fileset(fsv.ref)
            seen = set()
            for dep in deps:
                if dep != fsv.ref and dep not in seen:
                    seen.add(dep)
                    self.provenance.add_creation_edge(
                        src=dep, dst=fsv.ref, creator=creator)
        return fsv

    # convenience wrappers matching the paper's examples ----------------
    def merge(self, name: str, set_refs: list[str], creator: str = ""):
        return self.create(name, [f"/@{r}" for r in set_refs], creator)

    def update(self, name: str, extra_specs: list[str], creator: str = ""):
        return self.create(name, [f"/@{name}"] + extra_specs, creator)

    def subset(self, name: str, src_ref: str, prefix: str,
               creator: str = ""):
        return self.create(name, [f"{prefix}@{src_ref}"], creator)

    # ------------------------------------------------------------------
    def materialize(self, ref: str, dest_dir) -> list[str]:
        """Download a file set's files into dest_dir as unversioned files
        (what the job agent does before running a job)."""
        from pathlib import Path
        fsv = self.resolve(ref)
        dest = Path(dest_dir)
        out = []
        for path, version in sorted(fsv.files.items()):
            data = self.storage._get_blob(
                self.storage.resolve(path, version).blob)
            local = dest / path.lstrip("/")
            local.parent.mkdir(parents=True, exist_ok=True)
            local.write_bytes(data)
            out.append(str(local))
        return out
