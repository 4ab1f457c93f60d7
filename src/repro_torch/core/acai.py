"""ACAI project workspaces (a copy of ``AcaiProject`` from
``repro/core/acai.py``): one project's data lake, metadata and provenance
under one root, in the reference's files. The credential server, the
execution engine and ``AcaiPlatform`` are not copied yet.
"""
from __future__ import annotations

from pathlib import Path

from repro_torch.core.datalake.fileset import FileSetManager
from repro_torch.core.datalake.metadata import MetadataStore
from repro_torch.core.datalake.provenance import ProvenanceGraph
from repro_torch.core.datalake.storage import Storage


class AcaiProject:
    """Isolated workspace: data lake + metadata + provenance."""

    def __init__(self, name: str, root):
        self.name = name
        root = Path(root)
        root.mkdir(parents=True, exist_ok=True)
        self.storage = Storage(root)
        self.metadata = MetadataStore(root)
        self.provenance = ProvenanceGraph(root)
        self.filesets = FileSetManager(self.storage, self.provenance)

    # SDK conveniences -------------------------------------------------
    def upload(self, path: str, data: bytes, creator: str = "") -> str:
        fv = self.storage.upload(path, data, creator)
        self.metadata.register(f"{path}@{fv.version}", kind="file",
                               creator=creator)
        return f"{path}@{fv.version}"

    def create_file_set(self, name: str, specs: list[str],
                        creator: str = "") -> str:
        fsv = self.filesets.create(name, specs, creator)
        self.metadata.register(fsv.ref, kind="fileset", creator=creator)
        return fsv.ref
