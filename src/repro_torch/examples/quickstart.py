"""Quickstart (the port of ``examples/quickstart.py``): train a reduced-config
model end to end with the full stack (data pipeline, AdamW, remat, data-lake
versioned checkpoints, fault-tolerant supervision, provenance), then check
the checkpoint with an evaluation job through the execution engine.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.examples.quickstart [--arch olmo-1b]
        [--steps 30]

It runs on the card unless ``--device cpu`` is given, and raises without
one. The lake goes to a new directory under the temporary directory, or
under ``--workdir``.
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch import resolve_device
from repro_torch.configs.base import get_arch, list_archs
from repro_torch.core.acai import AcaiEngine, AcaiProject
from repro_torch.core.engine.registry import JobSpec
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import model as M
from repro_torch.train.checkpoints import CheckpointManager
from repro_torch.train.fault import TrainSupervisor
from repro_torch.train.optimizer import OptimizerConfig, leaves
from repro_torch.train.train_step import (TrainConfig, make_opt_state,
                                          make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    print(f"arch={args.arch} (reduced: {cfg.n_layers}L d={cfg.d_model}, "
          f"{cfg.n_params():,} params) on {dev}")

    params = M.init_params(cfg, 0, device=dev)
    tcfg = TrainConfig(remat="full")
    ocfg = OptimizerConfig(lr=3e-3, warmup_steps=5, total_steps=args.steps,
                           weight_decay=0.0)
    step = make_train_step(cfg, tcfg, ocfg, device=dev)
    opt = make_opt_state(params, tcfg)
    pipe = TokenPipeline(DataConfig(vocab_size=32, seq_len=32,
                                    global_batch=16, markov_temp=2.5), cfg)

    workdir = tempfile.mkdtemp(prefix="acai-quickstart-", dir=args.workdir)
    project = AcaiProject("quickstart", workdir)
    pipe.register(project, "synthetic-markov", creator="you")
    ckpt = CheckpointManager(project, "quickstart-run")
    sup = TrainSupervisor(ckpt, save_every=10)

    state, report = sup.run(step, {"params": params, "opt": opt, "step": 0},
                            args.steps, pipe.batch_at)
    print(f"ran {report.steps_run} steps, {report.checkpoints} checkpoints,"
          f" {report.restarts} restarts")

    # the checkpoint is a versioned fileset with metadata + provenance
    latest = ckpt.latest_step()
    restored, rstep = ckpt.restore({"params": state["params"],
                                    "opt": state["opt"]})
    print(f"latest checkpoint step={latest}; restored step={rstep}")
    print("datalake filesets:", project.filesets.list_sets())
    ids = project.metadata.find(kind="checkpoint")
    print("checkpoint metadata:", {i: project.metadata.get(i).get('loss')
                                   for i in ids[-2:]})

    # evaluation as a platform job: submit returns a JobHandle future and
    # .result() resolves it — no run_all(), no manual sequencing
    eng = AcaiEngine(datalake=project, workroot=workdir + "/jobs")

    def eval_job(wd, job):
        n_params = sum(p.numel() for p in leaves(restored["params"]))
        print(f"[[acai:eval_params={n_params},ckpt_step={rstep}]]")
        return {"params": int(n_params)}

    handle = eng.submit(JobSpec(name="eval", project="quickstart",
                                user="you", fn=eval_job,
                                resources={"vcpu": 1, "mem_mb": 512}))
    print(f"eval job {handle.job_id}: {handle.result()['params']:,} params "
          f"verified from checkpoint step {rstep}")
    return {"report": report, "restored_step": rstep, "workdir": workdir,
            "eval": handle.result()}


if __name__ == "__main__":
    main()
