"""Inter-job data caching (ACAI §7.1.2 — paper future work, implemented).

A copy of ``repro/core/datalake/cache.py``, with its imports in
``repro_torch.core``.

Every job normally starts by downloading its input fileset; when
consecutive jobs consume the same fileset VERSION, the materialized files
can be reused. The cache is keyed on the resolved fileset ref
(name:version — immutable by construction, so reuse is always safe), with
LRU eviction on a byte budget."""
from __future__ import annotations

import shutil
from collections import OrderedDict
from pathlib import Path


class FilesetCache:
    def __init__(self, root: str | Path, max_bytes: int = 1 << 30):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_bytes = max_bytes
        self._entries: OrderedDict[str, int] = OrderedDict()  # ref -> bytes
        self.hits = 0
        self.misses = 0

    def _dir_for(self, ref: str) -> Path:
        return self.root / ref.replace("/", "_").replace(":", "@")

    def materialize(self, filesets, ref: str, dest_dir: str | Path) -> bool:
        """Fill dest_dir with the fileset's files; returns True on a cache
        hit (files hard-copied from the cache instead of the lake)."""
        resolved = filesets.resolve(ref).ref
        cdir = self._dir_for(resolved)
        dest = Path(dest_dir)
        if resolved in self._entries:
            self._entries.move_to_end(resolved)
            shutil.copytree(cdir, dest, dirs_exist_ok=True)
            self.hits += 1
            return True
        self.misses += 1
        filesets.materialize(resolved, cdir)
        size = sum(p.stat().st_size for p in cdir.rglob("*") if p.is_file())
        self._entries[resolved] = size
        self._evict()
        shutil.copytree(cdir, dest, dirs_exist_ok=True)
        return False

    def _evict(self) -> None:
        while sum(self._entries.values()) > self.max_bytes \
                and len(self._entries) > 1:
            ref, _ = self._entries.popitem(last=False)
            shutil.rmtree(self._dir_for(ref), ignore_errors=True)

    @property
    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "bytes": sum(self._entries.values()),
                "entries": len(self._entries)}
