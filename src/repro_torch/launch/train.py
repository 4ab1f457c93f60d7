"""Single-device training driver (the port of ``repro/launch/train.py``'s
single-device branch): the synthetic token pipeline -> the train step ->
AdamW under ``TrainSupervisor``, which saves a checkpoint to the project's
data lake under ``--workdir`` every ``--save-every`` steps and at the end,
and restores the latest one after a failure. It prints the loss per step
and ends with the reference's ``done:`` line.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch llama-3.2-vision-11b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --full \\
        --steps 4 --seq-len 2048 --global-batch 4 --save-every 2 \\
        --workdir build/acai-train

Without ``--full`` it trains the reduced config, as the reference does;
every registered arch trains (the VLM's batches carry the pipeline's
seeded vision states, musicgen-large's (B, S, 4) code frames). At
``--full`` the 7B configs do not fit on one 80 GB card: fp32 params, grads
and AdamW's ``mu`` and ``nu`` take 16 bytes a param, 121 GB for rwkv6-7b
(7.58 B params) and 92 GB for zamba2-7b (5.74 B), before activations. The
data vocabulary is ``min(vocab, 64)``, as in the reference: the pipeline's
transition matrix is vocab², so the model's own 50304 would take 20 GB.
``--mesh`` (the sharded path) raises until the multi-device slice. The
default ``--workdir`` is ``acai-train`` in the temporary directory
(``/tmp/acai-train``, the reference's, unless ``TMPDIR`` says otherwise).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from pathlib import Path

from repro_torch import resolve_device
from repro_torch.configs.base import get_arch, list_archs
from repro_torch.core.acai import AcaiProject
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import model as M
from repro_torch.train.checkpoints import CheckpointManager
from repro_torch.train.fault import TrainSupervisor
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import (TrainConfig, make_opt_state,
                                          make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--full", action="store_true",
                    help="the full config (needs the card's memory)")
    ap.add_argument("--mesh", default=None, help="not ported yet")
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
        raise NotImplementedError("--mesh: the sharded train step is not "
                                  "ported yet; this driver uses one device")

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    tcfg = TrainConfig(remat=args.remat)
    ocfg = OptimizerConfig(lr=args.lr, warmup_steps=5,
                           total_steps=args.steps, weight_decay=0.0)
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


if __name__ == "__main__":
    main()
