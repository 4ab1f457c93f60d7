"""Dry-run: count every (arch x shape x mesh) cell on fake tensors (the port
of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's jitted step on 512
placeholder host devices and reads the compiled module. The port has no
compiler to ask: it runs one rank's real sharded step, on fake tensors,
inside a fake process group of the mesh's size, and counts what the step
dispatches. Per cell this:

  1. starts a fake process group (``torch.distributed``'s "fake" backend)
     of the production mesh's size, 256 ranks for (16, 16) or 512 for
     (2, 16, 16), as rank 0, and builds the ``DeviceMesh`` on it;
  2. installs the sharding rules and derives the param, optimizer, batch
     and decode-state specs (``build_cell``), and builds this rank's state
     under them as DTensors over ``FakeTensor`` shards: nothing is
     allocated;
  3. runs the train, prefill or serve step once under
     ``roofline/op_cost.py``'s counter: FLOPs, bytes, collectives by kind,
     the hand-written kernels' records (their wrappers launch nothing on a
     fake tensor and count their ``KernelSpec.cost``), and the peak of live
     bytes;
  4. reports the reference's JSON: ``memory_analysis`` (the arguments, the
     outputs, and the peak of the step's own storages as the temp bytes)
     and the roofline (``roofline/analysis.py``, with the H100's
     constants). Nothing is compiled: ``lower_s`` is the counting time and
     ``compile_s`` is null.

The fake process group ends with the cell, also when the cell fails; a
process that already has a process group cannot run a cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
        --arch olmo-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --all

``--device`` defaults to "cuda", as every entry point of the port: the
fake tensors are CUDA tensors, and the counts are the same as on the CPU
(``chip_smoke.py`` phase 13 holds them equal on the H100). On a torch
built without CUDA pass ``--device cpu``: there an autograd graph over
fake CUDA tensors aborts the process (a ``c10::Error`` in
``getDeviceGuardImpl``), it does not raise. The results go to ``--out``
(``build/dryrun/`` by default), one JSON file a cell.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Callable, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, get_arch, list_archs
from repro_torch.configs.shapes import SHAPES, ShapeConfig, applicable
from repro_torch.train.train_step import TrainConfig

HBM_BYTES = 80e9          # an H100 SXM's HBM3


class TensorSpec(NamedTuple):
    """A tensor's shape and dtype, the reference's ``ShapeDtypeStruct``."""
    shape: tuple
    dtype: torch.dtype


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Stand-ins for every model input of the global batch."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "decode":
        tok_shape = (b, 1, cfg.n_codebooks) if cfg.n_codebooks else (b, 1)
        out = {"tokens": TensorSpec(tok_shape, i32),
               "cache_len": TensorSpec((b,), i32)}
    else:
        tok_shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
        out = {"tokens": TensorSpec(tok_shape, i32)}
        if shape.kind == "train":
            out["labels"] = TensorSpec(tok_shape, i32)
    if cfg.family == "vlm":
        out["vision"] = TensorSpec((b, cfg.n_vision_tokens, cfg.vision_dim),
                                   torch.bfloat16)
    return out


@dataclasses.dataclass
class Cell:
    """One rank's step, its arguments (the state as DTensors over fake
    shards, the global batch as fake tensors) and the spec trees they were
    built under: "params", "batch", and "opt_state" (train) or "state"
    (decode)."""
    step: Callable
    args: tuple
    specs: dict


def _empty_tree(shapes, dtype, device):
    """A tree of ``torch.Size`` leaves -> empty tensors of those shapes."""
    return {k: _empty_tree(v, dtype, device) if isinstance(v, dict)
            else torch.empty(v, dtype=dtype, device=device)
            for k, v in shapes.items()}


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
               tcfg: TrainConfig, serve_layout: str = "fsdp",
               device="cuda") -> Cell:
    """This rank's step of the cell on ``mesh`` (a ``DeviceMesh``) and its
    arguments, built as the reference's ``build_cell`` builds its jit: fp32
    params (bf16 where the reference makes them bf16: the resident serving
    layout, ``master_weights``) under ``param_specs`` (FSDP but for the
    resident layout), AdamW's moments under ``opt_state_specs`` (ZeRO-1),
    the masters under the moments' specs and the residuals under the
    params', the decode state under ``decode_state_specs``, and the global
    batch of ``input_specs``. Call it under a ``FakeTensorMode``: every
    tensor is full size."""
    from torch._guards import active_fake_mode

    from repro_torch.models import model as M
    from repro_torch.serve import decode as D
    from repro_torch.sharding import rules as SR
    from repro_torch.sharding import spmd as S
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptimizerConfig
    if active_fake_mode() is None:
        raise RuntimeError("build_cell allocates the cell's full state: "
                           "call it under a FakeTensorMode")
    dev = resolve_device(device)
    rules = SR.AxisRules.for_mesh(mesh)
    SR.set_rules(rules)
    resident = serve_layout == "resident" and shape.kind == "decode"
    bf16 = resident or (shape.kind == "train" and tcfg.master_weights)
    _, pspecs, ospecs = TS.sharded_specs(cfg, mesh, fsdp=not resident)
    full = _empty_tree(M.param_shapes(cfg),
                       torch.bfloat16 if bf16 else torch.float32, dev)
    batch = {k: torch.empty(spec.shape, dtype=spec.dtype, device=dev)
             for k, spec in input_specs(cfg, shape).items()}
    layout = serve_layout if shape.kind == "decode" else "fsdp"
    specs = {"params": pspecs,
             "batch": SR.batch_specs(cfg, shape.kind, shape.global_batch,
                                     rules, layout=layout)}

    if shape.kind == "train":
        if tcfg.master_weights:
            ospecs["master"] = ospecs["mu"]
        if tcfg.grad_compression:
            ospecs["residuals"] = pspecs
        params, opt_state = TS.shard_train_state(full, tcfg, pspecs, ospecs,
                                                 mesh)
        step = TS.make_sharded_train_step(
            cfg, tcfg, OptimizerConfig(), mesh, device=dev,
            specs=(rules, pspecs, ospecs))
        specs["opt_state"] = ospecs
        return Cell(step, (params, opt_state, batch), specs)

    params = S.distribute(full, pspecs, mesh)
    del full
    if shape.kind == "prefill":
        step = D.make_sharded_prefill_step(cfg, mesh, device=dev)
        return Cell(step, (params, batch), specs)

    state = D.init_sharded_decode_state(
        cfg, mesh, shape.global_batch, shape.seq_len, device=dev,
        vision=batch.get("vision"), params=params, layout=serve_layout)
    step = D.make_sharded_serve_step(cfg, mesh, shape.seq_len, device=dev,
                                     layout=serve_layout)
    specs["state"] = SR.decode_state_specs(cfg, shape.global_batch, rules,
                                           layout=serve_layout)
    return Cell(step, (params, state, batch), specs)


def _mesh_axes(mesh_shape: tuple) -> tuple:
    return ("pod", "data", "model")[-len(mesh_shape):]


def _tag(arch: str, shape_name: str, multi_pod: bool) -> str:
    return f"{arch}__{shape_name}__{'multi' if multi_pod else 'single'}"


def _write(out_dir, tag: str, result: dict) -> None:
    if out_dir:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{tag}.json").write_text(json.dumps(result, indent=1))


def count_cell(cfg: ArchConfig, shape: ShapeConfig, mesh_shape: tuple, *,
               tcfg: TrainConfig, serve_layout: str = "fsdp",
               device="cuda") -> dict:
    """One rank's count of the cell on a fake mesh of ``mesh_shape``
    (("data", "model"), or ("pod", "data", "model") for three dims):
    {"cost": its ``op_cost.Cost``, "args_bytes", "out_bytes", "seconds"}.
    It starts a fake process group of the mesh's size and ends it, also
    when the cell fails."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.roofline import op_cost
    from repro_torch.sharding.rules import set_rules
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a dry-run starts a fake process group of its "
                           "own: run it in a process that has none")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(mesh_shape))
    try:
        t0 = time.perf_counter()
        mesh = make_mesh(mesh_shape, _mesh_axes(mesh_shape),
                         device_type=dev.type)
        with FakeTensorMode():
            cell = build_cell(cfg, shape, mesh, tcfg=tcfg,
                              serve_layout=serve_layout, device=dev)
            with op_cost.counting(known=cell.args) as cost:
                out = cell.step(*cell.args)
            return {"cost": cost, "seconds": time.perf_counter() - t0,
                    "args_bytes": op_cost.local_bytes(cell.args),
                    "out_bytes": op_cost.local_bytes(out)}
    finally:
        set_rules(None)
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             mesh_shape: tuple | None = None, cfg: ArchConfig | None = None,
             tcfg: TrainConfig | None = None, out_dir="build/dryrun",
             serve_layout: str = "fsdp", device="cuda",
             verbose: bool = True) -> dict:
    """The reference's ``run_cell`` on fake tensors: the cell's JSON (and
    its file under ``out_dir`` unless that is None). ``mesh_shape``: a
    fake mesh other than the production one (the reference's ``mesh``);
    ``cfg``: a config other than ``arch``'s registered one (a cut depth),
    whose name the result keeps as ``arch``."""
    from repro_torch.launch.mesh import production_shape
    from repro_torch.roofline import analysis as RA
    cfg = cfg or get_arch(arch)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    label = f"{arch} x {shape_name} x {'multi' if multi_pod else 'single'}-pod"
    tag = _tag(arch, shape_name, multi_pod)
    if not ok:
        if verbose:
            print(f"[SKIP] {label}: {why}")
        result = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                  "status": "n/a", "reason": why}
        _write(out_dir, tag, result)
        return result
    tcfg = tcfg or TrainConfig()
    mesh_shape = tuple(mesh_shape or
                       production_shape(multi_pod=multi_pod)[0])
    n_chips = math.prod(mesh_shape)
    got = count_cell(cfg, shape, mesh_shape, tcfg=tcfg,
                     serve_layout=serve_layout, device=device)
    cost = got["cost"]
    mem = {"argument_size_in_bytes": got["args_bytes"],
           "output_size_in_bytes": got["out_bytes"],
           "temp_size_in_bytes": cost.peak_bytes}
    peak = got["args_bytes"] + cost.peak_bytes
    roof = RA.analyze(cost, cfg, shape, n_chips)
    result = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "status": "ok", "n_chips": int(n_chips),
        "lower_s": round(got["seconds"], 2), "compile_s": None,
        "memory_analysis": mem,
        "roofline": roof.as_dict(),
        "train_config": dataclasses.asdict(tcfg),
        "device": str(resolve_device(device)),
        "mesh_shape": list(mesh_shape),
        "predicted_peak_bytes": peak,
        "fits_80gb": peak <= HBM_BYTES,
    }
    if verbose:
        print(f"[OK] {label}: chips={n_chips} "
              f"count={got['seconds']:.1f}s "
              f"compute={roof.compute_s*1e3:.1f}ms "
              f"memory={roof.memory_s*1e3:.1f}ms "
              f"collective={roof.collective_s*1e3:.1f}ms "
              f"dominant={roof.dominant} "
              f"useful={roof.useful_flops_ratio:.2f} "
              f"roofline_frac={roof.roofline_fraction:.3f} "
              f"peak={peak / 1e9:.2f}GB")
        print(f"     memory_analysis: {mem}")
    _write(out_dir, tag, result)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run on fake "
                                 "tensors")
    ap.add_argument("--arch", default=None, choices=list_archs() + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--remat", default="full",
                    choices=["none", "full", "dots"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (cuda or cpu)")
    args = ap.parse_args()
    tcfg = TrainConfig(remat=args.remat, microbatches=args.microbatches)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    run_cell(arch, shape, multi_pod=mp, tcfg=tcfg,
                             out_dir=args.out, device=args.device)
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, shape, mp, repr(e)))
                    print(f"[FAIL] {arch} x {shape} x "
                          f"{'multi' if mp else 'single'}: {e!r}")
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed: {failures}")


if __name__ == "__main__":
    main()
