"""Single-device training driver (the port of ``repro/launch/train.py``'s
single-device branch): the synthetic token pipeline -> the train step ->
AdamW, printing the loss per step.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --full \\
        --steps 4 --seq-len 2048 --global-batch 4

Without ``--full`` it trains the reduced config, as the reference does. The
data vocabulary is ``min(vocab, 64)``, as in the reference: the pipeline's
transition matrix is vocab², so the model's own 50304 would take 20 GB.
Left out until checkpoints and supervision are ported: the reference's
``TrainSupervisor`` loop, ``--save-every`` and ``--workdir``. ``--mesh``
(the sharded path) raises until the multi-device slice.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import resolve_device
from repro_torch.configs.base import get_arch, list_archs
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import model as M
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

    losses = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, pipe.batch_at(i))
        losses.append(float(metrics["loss"]))     # waits for the step
        print(f"step {i}: loss {losses[-1]:.4f} grad_norm "
              f"{float(metrics['grad_norm']):.4f} lr {float(metrics['lr']):.3e}"
              f" ({1e3 * (time.perf_counter() - t0):.1f} ms)", flush=True)
    print(f"done: {cfg.name} on {dev}, {args.steps} steps, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
