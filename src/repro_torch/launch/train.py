"""Training driver (the port of ``repro/launch/train.py``): the synthetic
token pipeline -> the train step -> AdamW under ``TrainSupervisor``, which
saves a checkpoint to the project's data lake under ``--workdir`` every
``--save-every`` steps and at the end, and restores the latest one after a
failure. It prints the loss per step and ends with the reference's
``done:`` line.

With ``--mesh DxM`` it starts D·M ranks itself (one process each; rank r on
``cuda:(r % devices)``, or the CPU with ``--device cpu``) on a ("data",
"model") ``DeviceMesh`` and runs ``build_sharded_train``'s step: FSDP and
ZeRO-1 over data, tensor parallelism (and the MoE's expert parallelism)
over model, as the reference's ``param_specs`` and ``opt_state_specs``
lay them out. ``--backend`` is nccl on the card and gloo on the CPU unless
named; nccl needs a device a rank, so ranks that share one card need
``--backend gloo``. Every rank draws the same seeded init; rank 0 alone
writes the lake and prints.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch llama-3.2-vision-11b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --full \\
        --steps 4 --seq-len 2048 --global-batch 4 --save-every 2 \\
        --workdir build/acai-train
    PYTHONPATH=src python -m repro_torch.launch.train --mesh 2x2 \\
        --device cpu --backend gloo
    PYTHONPATH=src python -m repro_torch.launch.train --mesh 1x2 \\
        --backend gloo          # two ranks sharing one card

Without ``--full`` it trains the reduced config, as the reference does;
every registered arch trains (the VLM's batches carry the pipeline's
seeded vision states, musicgen-large's (B, S, 4) code frames). At
``--full`` the 7B configs do not fit on one 80 GB card: fp32 params, grads
and AdamW's ``mu`` and ``nu`` take 16 bytes a param, 121 GB for rwkv6-7b
(7.58 B params) and 92 GB for zamba2-7b (5.74 B), before activations. The
data vocabulary is ``min(vocab, 64)``, as in the reference: the pipeline's
transition matrix is vocab², so the model's own 50304 would take 20 GB.
The default ``--workdir`` is ``acai-train`` in the temporary directory
(``/tmp/acai-train``, the reference's, unless ``TMPDIR`` says otherwise).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from pathlib import Path

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_arch, list_archs
from repro_torch.core.acai import AcaiProject
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import model as M
from repro_torch.train.checkpoints import CheckpointManager
from repro_torch.train.fault import TrainSupervisor
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train import train_step as TS
from repro_torch.train.train_step import (TrainConfig, make_opt_state,
                                          make_train_step)


def build_sharded_train(cfg, tcfg, ocfg, mesh, *, device="cuda"):
    """(step, param specs, opt-state specs) on ``mesh`` (the reference's
    assembly: rules installed, params under ``param_specs(fsdp=True)``,
    the moments under ``opt_state_specs``; the reference returns the
    first two)."""
    from repro_torch.sharding.rules import set_rules
    specs = TS.sharded_specs(cfg, mesh)
    set_rules(specs[0])
    return (TS.make_sharded_train_step(cfg, tcfg, ocfg, mesh, device=device,
                                       specs=specs), *specs[1:])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--full", action="store_true",
                    help="the full config (needs the card's memory)")
    ap.add_argument("--mesh", default=None,
                    help="DxM: D*M ranks on a (data, model) mesh")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the ranks' process group (default: nccl on the "
                         "card, gloo on the CPU)")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(), "acai-train"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh:
        return _main_mesh(args)

    dev = resolve_device(args.device)
    cfg, tcfg, ocfg = _config(args)
    step = make_train_step(cfg, tcfg, ocfg, device=dev)
    params = M.init_params(cfg, 0, device=dev)
    opt = make_opt_state(params, tcfg)
    pipe = TokenPipeline(DataConfig(
        vocab_size=min(cfg.vocab_size, 64), seq_len=args.seq_len,
        global_batch=args.global_batch, markov_temp=2.5), cfg)

    project = AcaiProject("train", Path(args.workdir))
    pipe.register(project, f"{args.arch}-data", creator="trainer")
    ckpt = CheckpointManager(project, f"{args.arch}-run")
    sup = TrainSupervisor(ckpt, save_every=args.save_every)

    losses, started = [], {}

    def batch_fn(i):
        started.update(step=i, t0=time.perf_counter())
        return pipe.batch_at(i)

    def step_fn(params, opt, batch):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))     # waits for the step
        print(f"step {started['step']}: loss {losses[-1]:.4f} grad_norm "
              f"{float(metrics['grad_norm']):.4f} lr {float(metrics['lr']):.3e}"
              f" ({1e3 * (time.perf_counter() - started['t0']):.1f} ms)",
              flush=True)
        return params, opt, metrics

    _, report = sup.run(step_fn, {"params": params, "opt": opt, "step": 0},
                        args.steps, batch_fn)
    print(f"{cfg.name} on {dev}: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"done: {report.steps_run} steps, {report.checkpoints} ckpts, "
          f"latest={ckpt.latest_step()}")
    return losses


def _config(args):
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    return cfg, TrainConfig(remat=args.remat), OptimizerConfig(
        lr=args.lr, warmup_steps=5, total_steps=args.steps, weight_decay=0.0)


def _main_mesh(args):
    from repro_torch.launch import mesh as LM
    shape, _ = LM.parse_mesh(args.mesh)
    world = 1
    for n in shape:
        world *= n
    backend = args.backend or ("gloo" if resolve_device(args.device).type
                               == "cpu" else "nccl")
    LM.check_backend(backend, args.device, world)
    print(f"mesh {args.mesh}: {world} ranks on {backend}, device "
          f"{args.device}", flush=True)
    LM.run_ranks(_rank_main, world, (vars(args), backend,
                                     f"tcp://localhost:{LM.free_port()}"))


def _rank_main(rank: int, world: int, opts: dict, backend: str,
               init_method: str):
    """One rank of ``--mesh``: the same seeded init on every rank, this
    rank's shards of it, the sharded step under ``TrainSupervisor``; rank
    0 writes the lake and prints."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as LM
    args = argparse.Namespace(**opts)
    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = LM.init_rank(rank, world, backend=backend, device=args.device,
                       init_method=init_method)
    try:
        shape, axes = LM.parse_mesh(args.mesh)
        mesh = LM.make_mesh(shape, axes, device_type=dev.type)
        cfg, tcfg, ocfg = _config(args)
        step, pspecs, ospecs = build_sharded_train(cfg, tcfg, ocfg, mesh,
                                                   device=dev)
        params, opt = TS.shard_train_state(M.init_params(cfg, 0, device=dev),
                                           tcfg, pspecs, ospecs, mesh)
        pipe = TokenPipeline(DataConfig(
            vocab_size=min(cfg.vocab_size, 64), seq_len=args.seq_len,
            global_batch=args.global_batch, markov_temp=2.5), cfg)
        project = None           # the lake is rank 0's
        if rank == 0:
            project = AcaiProject("train", Path(args.workdir))
            pipe.register(project, f"{args.arch}-data", creator="trainer")
        ckpt = CheckpointManager(project, f"{args.arch}-run", mesh=mesh)
        sup = TrainSupervisor(ckpt, save_every=args.save_every)
        losses, started = [], {}

        def batch_fn(i):
            started.update(step=i, t0=time.perf_counter())
            return pipe.batch_at(i)

        def step_fn(params, opt, batch):
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))
            if rank == 0:
                print(f"step {started['step']}: loss {losses[-1]:.4f} "
                      f"grad_norm {float(metrics['grad_norm']):.4f} lr "
                      f"{float(metrics['lr']):.3e} ("
                      f"{1e3 * (time.perf_counter() - started['t0']):.1f} "
                      "ms)", flush=True)
            return params, opt, metrics

        _, report = sup.run(step_fn, {"params": params, "opt": opt,
                                      "step": 0}, args.steps, batch_fn)
        latest = ckpt.latest_step()          # collective: every rank asks
        if rank == 0:
            print(f"{cfg.name} on a {args.mesh} mesh ({world} ranks, "
                  f"{backend}, {dev.type}): loss {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f}")
            print(f"done: {report.steps_run} steps, {report.checkpoints} "
                  f"ckpts, latest={latest}", flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
