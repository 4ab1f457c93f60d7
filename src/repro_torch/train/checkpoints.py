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
restore.

On a mesh (``CheckpointManager(..., mesh=)``, every rank of the process
group) the lake is rank 0's: the other ranks may pass no project, since a
project object holds its records in memory and would not see rank 0's
writes. ``save`` is collective: every rank gathers each DTensor leaf whole
(in the keys' order) and rank 0 alone writes the archive and the records,
so a checkpoint written on a mesh restores on one device and back.
``latest_step`` and ``restore``'s lookup run on rank 0 and reach every
rank, and every rank reads the archive. ``restore`` places each leaf on a
mesh: the template's own (a DTensor template leaf keeps its mesh and
placements), or ``mesh`` with ``specs``, any rank count, and a different
one from the save's.
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
    as they are; a DTensor gathered whole."""
    from repro_torch.sharding.spmd import full_tensor
    leaf = full_tensor(leaf).detach().cpu()
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
    def __init__(self, project: Optional[AcaiProject], run_name: str,
                 keep: int = 3, *, mesh=None):
        self.project = project
        self.run = run_name
        self.keep = keep          # stored, never used, as in the reference
        self.mesh = mesh          # a DeviceMesh: rank 0's lake, collective

    @property
    def fileset(self) -> str:
        return f"{self.run}-ckpt"

    def _from_rank0(self, fn):
        """fn() where the lake's records are (rank 0 on a mesh), its value
        on every rank."""
        if self.mesh is None:
            return fn()
        import torch.distributed as dist
        box = [fn() if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    # ------------------------------------------------------------------
    def save(self, step: int, params, opt_state=None,
             extra: Optional[dict] = None, job_id: Optional[str] = None,
             input_fileset: Optional[str] = None) -> str:
        state = {"params": params}
        if opt_state is not None:
            state["opt"] = opt_state
        flat = flatten(state)
        if self.mesh is None:
            from torch.distributed.tensor import DTensor
            if any(isinstance(v, DTensor) for v in flat.values()):
                raise ValueError("DTensor state: give the manager its mesh "
                                 "(CheckpointManager(..., mesh=))")
            return self._write(step, flat, extra, job_id, input_fileset)
        import torch.distributed as dist

        from repro_torch.sharding.spmd import full_tensor
        if dist.get_rank():
            for leaf in flat.values():      # rank 0's gathers, in its order
                full_tensor(leaf)
        return self._from_rank0(lambda: self._write(
            step, flat, extra, job_id, input_fileset))

    def _write(self, step, flat, extra, job_id, input_fileset) -> str:
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
        return self._from_rank0(self._latest_step)

    def _latest_step(self) -> Optional[int]:
        if not self.project.filesets.exists(self.fileset):
            return None
        ref = self.project.filesets.resolve(self.fileset).ref
        return self.project.metadata.get(ref).get("step")

    def restore(self, template, *, version: Optional[int] = None,
                device=None, mesh=None, specs=None):
        """Rebuild ``template``-shaped state: each leaf in the template
        leaf's dtype, on the template leaf's device or on ``device``, in
        memory of its own (never the template's, which a train step may
        go on updating in place). Placed on a mesh: a DTensor template
        leaf as a DTensor of its mesh and placements; with ``mesh`` (a
        ``DeviceMesh``) and ``specs`` (a spec tree shaped like the
        template), every leaf as this rank's shard under its spec. A leaf
        the specs do not name and a 0-d leaf come back as plain tensors,
        the same on every rank. Every rank reads the archive.
        Returns (state, step)."""
        from torch.distributed.tensor import DTensor

        from repro_torch.sharding import spmd as S
        flat_specs = flatten(specs) if specs is not None else {}
        if (mesh is None) != (specs is None):
            raise ValueError("restore onto a mesh needs both mesh and specs")
        blob, step = self._from_rank0(lambda: self._lookup(version))
        with np.load(blob, allow_pickle=False) as npz:
            def load(key, tmpl):
                # np.load reads each entry into a new writable array, so a
                # leaf that stays on the host in its dtype owns it alone
                full = torch.from_numpy(npz[key])
                where = mesh if mesh is not None else (
                    tmpl.device_mesh if isinstance(tmpl, DTensor) else None)
                dev = device if device is not None else tmpl.device \
                    if where is None else torch.device(
                        "cuda", torch.cuda.current_device()) \
                    if where.device_type == "cuda" else torch.device("cpu")
                if where is None or not full.dim() or (
                        mesh is not None and key not in flat_specs):
                    return full.to(device=dev, dtype=tmpl.dtype)
                spec = flat_specs[key] if mesh is not None \
                    else S.spec_of(tmpl)
                local = S.shard_of(full, spec, where).to(device=dev,
                                                        dtype=tmpl.dtype)
                return S.from_local(local, spec, where, full.shape)

            state = _unflatten_like(template, load)
        return state, step

    def _lookup(self, version: Optional[int]) -> tuple[str, int]:
        """(the archive's blob path, the manifest's step) of a version."""
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
        return str(blob), man["step"]
