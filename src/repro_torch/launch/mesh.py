"""Meshes and ranks (the port of ``repro/launch/mesh.py``).

``make_mesh`` returns a ``DeviceMesh`` over the process group's ranks;
``make_production_mesh`` and ``mesh_for_chips`` keep the reference's shapes
and return an ``AbstractMesh`` when no process group of that size exists
(the spec functions read either). One process per rank: ``init_rank``
joins the group, ``run_ranks`` starts a world of them.

Ranks sharing one card: NCCL does not let two ranks of one communicator
use one device, so a world with more ranks than devices runs on ``gloo``
(asked for by name; nothing switches backend), with the ranks' tensors on
the card and each collective's tensors staged through host memory
(``sharding/spmd.py``).
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import Callable

from repro_torch.sharding.mesh import make_abstract_mesh


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` over the process group's ranks, in
    rank order (the last axis fastest); the device type is the ranks'
    (``cuda`` when the group's backend is nccl or a card was set)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() and (
            dist.get_backend() == "nccl" or torch.cuda.is_initialized()) \
            else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def _mesh_or_abstract(shape, axes):
    import torch.distributed as dist
    n = 1
    for s in shape:
        n *= s
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() == n:
        return make_mesh(shape, axes)
    return make_abstract_mesh(shape, axes)


def production_shape(*, multi_pod: bool = False):
    """(shape, axes) of a production mesh: 16x16 = 256 ranks ("data",
    "model"); multi-pod adds a leading "pod" axis (2 x 16 x 16 = 512)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh (``production_shape``)."""
    return _mesh_or_abstract(*production_shape(multi_pod=multi_pod))


def mesh_for_chips(chips: int, model_axis: int = 16, *,
                   pod_size: int = 256):
    """Auto-provisioner search points: chips -> (pod?, data, model) mesh.
    Chips beyond one pod add a 'pod' axis (inter-pod = DP)."""
    if chips <= pod_size:
        model = min(model_axis, chips)
        data = chips // model
        return _mesh_or_abstract((data, model), ("data", "model"))
    pods = chips // pod_size
    model = model_axis
    data = pod_size // model
    return _mesh_or_abstract((pods, data, model), ("pod", "data", "model"))


def parse_mesh(text: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """"DxM" -> ((D, M), ("data", "model")); "D" -> ((D,), ("data",))."""
    shape = tuple(int(x) for x in text.lower().split("x"))
    if not 1 <= len(shape) <= 2 or min(shape) < 1:
        raise ValueError(f"mesh {text!r}: give D or DxM")
    return shape, ("data", "model")[:len(shape)]


def free_port() -> int:
    """A free TCP port on localhost for the group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_backend(backend: str, device: str, world: int) -> None:
    """NCCL runs on CUDA devices, one a rank: it refuses the CPU and a
    world with more ranks than devices (ranks that share a card name
    ``--backend gloo``); nothing switches backend for the caller."""
    import torch
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend != "nccl":
        return
    if torch.device(device).type != "cuda":
        raise RuntimeError("nccl runs on CUDA devices; use --backend gloo "
                           "with --device cpu")
    if world > torch.cuda.device_count():
        raise RuntimeError(
            f"nccl needs a device a rank: {world} ranks on "
            f"{torch.cuda.device_count()} device(s); run ranks that share a "
            "card with --backend gloo")


def init_rank(rank: int, world: int, *, backend: str, device: str,
              init_method: str, timeout_s: float = 300.0):
    """Join the group as ``rank`` of ``world`` and return this rank's
    device: ``cuda:(rank % device count)`` for ``device="cuda"``, else the
    CPU. NCCL needs a device a rank, so it refuses a world with more ranks
    than devices (name ``--backend gloo`` for ranks that share a card)."""
    import torch
    import torch.distributed as dist

    from repro_torch import resolve_device
    dev = resolve_device(device)
    check_backend(backend, device, world)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    os.environ.setdefault("LOCAL_RANK", str(dev.index or 0))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **({"device_id": dev} if backend == "nccl"
                               else {}))
    return dev


def run_ranks(fn: Callable, world: int, args: tuple = ()) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes and
    wait for all; a rank that fails ends the others and raises here."""
    import torch.multiprocessing as mp
    mp.start_processes(fn, args=(world, *args), nprocs=world, join=True,
                       start_method="spawn")
