"""Datalake-versioned checkpoints (the port of
``repro/train/checkpoints.py``) over the port's nested dicts of tensors.

Checkpoints are ACAI filesets ("<run>-ckpt" versions), written through a
transactional upload session (a crashed save never becomes a visible
version) with provenance edges from the training job. The files are the
reference's: ``state.npz`` keyed by ``convert.flatten``'s ``/``-joined
paths (the reference's ``_flatten`` keys; bf16 leaves widened to fp32,
since npz has no bf16) and ``manifest.json`` (step, sorted keys, extra), so
a checkpoint of either package restores in the other bit for bit.

The npz is written one leaf at a time (each leaf is copied to the host
only while its entry is written) and read one leaf at a time from the
blob's file, so host memory holds the archive once on save and one leaf on
restore. Restore onto a mesh (``mesh``, ``specs``) waits for the
multi-device slice.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.convert import flatten
from repro_torch.core.acai import AcaiProject
from repro_torch.core.datalake.storage import DataLakeError


def _host(leaf: torch.Tensor) -> np.ndarray:
    """A leaf as the host array the npz holds: bf16 widened to fp32 (the
    template's dtype comes back on restore); int32 and zero-size leaves
    as they are."""
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
        leaf = leaf.float()
    return leaf.numpy()


def npz_bytes(flat: dict[str, Any]) -> io.BytesIO:
    """``np.savez(buf, **flat)``'s archive (stored entries, zip64 forced,
    ``<key>.npy`` in ``flat``'s order), with each leaf taken to the host
    only while its entry is written."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in flat.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, _host(leaf), allow_pickle=False)
    return buf


def _unflatten_like(template: dict, load, prefix: str = "") -> dict:
    """``template``'s nested dicts with each leaf ``load(key, leaf)``."""
    out = {}
    for k, v in template.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        out[k] = _unflatten_like(v, load, key) if isinstance(v, dict) \
            else load(key, v)
    return out


class CheckpointManager:
    def __init__(self, project: AcaiProject, run_name: str,
                 keep: int = 3):
        self.project = project
        self.run = run_name
        self.keep = keep          # stored, never used, as in the reference

    @property
    def fileset(self) -> str:
        return f"{self.run}-ckpt"

    # ------------------------------------------------------------------
    def save(self, step: int, params, opt_state=None,
             extra: Optional[dict] = None, job_id: Optional[str] = None,
             input_fileset: Optional[str] = None) -> str:
        state = {"params": params}
        if opt_state is not None:
            state["opt"] = opt_state
        flat = flatten(state)
        buf = npz_bytes(flat)
        manifest = {"step": step, "keys": sorted(flat),
                    "extra": extra or {}}
        storage = self.project.storage
        paths = [f"/{self.fileset}/state.npz", f"/{self.fileset}/manifest.json"]
        sid = storage.begin_session(paths, creator="trainer")
        with buf.getbuffer() as view:
            storage.session_put(sid, paths[0], view)
        del buf
        storage.session_put(sid, paths[1], json.dumps(manifest).encode())
        fvs = storage.commit_session(sid)
        fsv = self.project.filesets.create(
            self.fileset, [f"{fv.path}@{fv.version}" for fv in fvs],
            creator="trainer")
        self.project.metadata.register(fsv.ref, kind="checkpoint",
                                       step=step, run=self.run,
                                       **(extra or {}))
        if job_id is not None:
            src = None
            if input_fileset:
                src = self.project.filesets.resolve(input_fileset).ref
            self.project.provenance.add_job_edge(src=src, dst=fsv.ref,
                                                 job_id=job_id)
        return fsv.ref

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        if not self.project.filesets.exists(self.fileset):
            return None
        ref = self.project.filesets.resolve(self.fileset).ref
        return self.project.metadata.get(ref).get("step")

    def restore(self, template, *, version: Optional[int] = None,
                device=None, mesh=None, specs=None):
        """Rebuild ``template``-shaped state: each leaf in the template
        leaf's dtype, on the template leaf's device or on ``device``, in
        memory of its own (never the template's, which a train step may
        go on updating in place). Returns (state, step)."""
        if mesh is not None or specs is not None:
            raise NotImplementedError(
                "restore onto a mesh (mesh, specs) waits for the "
                "multi-device slice (ROADMAP A11)")
        ref = self.fileset if version is None else \
            f"{self.fileset}:{version}"
        fsv = self.project.filesets.resolve(ref)
        storage = self.project.storage
        npz_path, man_path = (f"/{self.fileset}/state.npz",
                              f"/{self.fileset}/manifest.json")
        man = json.loads(storage.download(
            f"{man_path}@{fsv.files[man_path]}"))
        blob = storage.blob_path(npz_path, fsv.files[npz_path])
        if not blob.exists():
            raise DataLakeError(f"missing blob {blob.name}")
        with np.load(blob, allow_pickle=False) as npz:
            def load(key, tmpl):
                # np.load reads each entry into a new writable array, so a
                # leaf that stays on the host in its dtype owns it alone
                return torch.from_numpy(npz[key]).to(
                    device=tmpl.device if device is None else device,
                    dtype=tmpl.dtype)

            state = _unflatten_like(template, load)
        return state, man["step"]
