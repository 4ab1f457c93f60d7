"""The paper's usability-study workflow (section 5.2) as a declared
Pipeline (the port of ``examples/hyperparam_sweep.py``): ETL stage ->
horizontal hyperparameter sweep (``pipeline.map``) -> report stage, with
no manual sequencing. Stage edges are inferred from the dataflow (one
stage's output_fileset feeding another's input_fileset), the scheduler
gates each stage on its parents, every handle resolves in dependency
order, and provenance records one edge per declared DAG edge; a broken
ETL upstream-fails its whole subtree.

    PYTHONPATH=src python -m repro_torch.examples.hyperparam_sweep --device cpu
    PYTHONPATH=src python -m repro_torch.examples.hyperparam_sweep

The jobs' tensors live on ``--device`` (the card unless ``--device cpu``
is given; it raises without one). The raw dump comes from numpy seeds and
each sweep job's initial weights from a ``torch.Generator`` seeded by its
``args["seed"]`` (the reference draws them from ``jax.random``, which the
port cannot repeat); the MLP's math is ``fit``. The platform's root is a
new directory under the temporary directory, or under ``--workdir``.
"""
from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.acai import AcaiPlatform
from repro_torch.core.engine.registry import JobSpec

GRID = {"hidden": (8, 16, 32, 64), "lr": (0.5, 0.1)}
STEPS = 100


def etl_job(workdir, job):
    """Normalize the raw dump into the training fileset."""
    dev = resolve_device(job.spec.args["device"])
    raw = json.loads((workdir / "raw/dump.json").read_text())
    x = torch.tensor(raw["x"], dtype=torch.float32, device=dev)
    x = (x - x.mean(0)) / (x.std(0, unbiased=False) + 1e-6)
    (workdir / "out/train.json").write_text(
        json.dumps({"x": x.tolist(), "y": raw["y"]}))
    print(f"[[acai:rows={len(raw['y'])}]]")


def fit(x, y, w0, v0, lr: float, steps: int):
    """``steps`` of gradient descent at ``lr`` on the mean binary
    cross-entropy of sigmoid(tanh(x w) v) against y, from (w0, v0);
    returns (w, v). Plain autograd, in the inputs' dtype and device."""
    w = w0.detach().clone().requires_grad_()
    v = v0.detach().clone().requires_grad_()
    for _ in range(steps):
        p = torch.sigmoid(torch.tanh(x @ w) @ v)
        loss = -torch.mean(y * torch.log(p + 1e-7)
                           + (1 - y) * torch.log(1 - p + 1e-7))
        gw, gv = torch.autograd.grad(loss, (w, v))
        with torch.no_grad():
            w -= lr * gw
            v -= lr * gv
    return w.detach(), v.detach()


def train_job(workdir, job):
    cfg = job.spec.args
    dev = resolve_device(cfg["device"])
    data = json.loads((workdir / "TrainSet/train.json").read_text())
    x = torch.tensor(data["x"], dtype=torch.float32, device=dev)
    y = torch.tensor(data["y"], dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(cfg["seed"])
    w0 = torch.randn((x.shape[1], cfg["hidden"]), generator=gen,
                     device=dev) * 0.1
    w, v = fit(x, y, w0, torch.zeros(cfg["hidden"], device=dev), cfg["lr"],
               cfg["steps"])
    acc = float(((torch.tanh(x @ w) @ v > 0) == (y > 0.5)).float().mean())
    (workdir / "out/model.json").write_text(
        json.dumps({"w": w.tolist(), "v": v.tolist()}))
    # the intelligent log parser turns this into queryable metadata
    print(f"[[acai:accuracy={acc},hidden={cfg['hidden']},lr={cfg['lr']}]]")
    return {"device": str(w.device)}        # the job's outputs, not metadata


def raw_dump():
    """The unnormalized dump: x (256, 16) ~ 3 N(0, 1) + 1.5 and labels of a
    seeded linear rule, from numpy seeds."""
    x = np.random.default_rng(0).standard_normal((256, 16)) * 3.0 + 1.5
    w_true = np.random.default_rng(1).standard_normal(16)
    y = ((x - 1.5) @ w_true > 0).astype(np.float32)
    return x.astype(np.float32), y


def main(argv=None) -> dict:
    """Runs the workflow and prints the reference's lines; returns a dict:
    stages, held, states, best (the report's metadata), edges, broken,
    and each sweep job's device (from its outputs)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    dev = str(resolve_device(args.device))

    root = tempfile.mkdtemp(prefix="acai-sweep-", dir=args.workdir)
    plat = AcaiPlatform(root, runner="thread", max_workers=4, quota_k=100)
    admin = plat.create_project(plat.admin_token, "sweep-demo")
    proj = plat.project(admin)

    # 0. only the RAW dump goes to the lake; the pipeline derives the rest
    x, y = raw_dump()
    proj.upload("/raw/dump.json",
                json.dumps({"x": x.tolist(), "y": y.tolist()}).encode(),
                creator="demo")
    proj.create_file_set("RawDump", ["/raw/dump.json"], creator="demo")

    def report_job(workdir, job):
        """Runs only after every sweep stage: one indexed query replaces
        the manual experiment log."""
        best = proj.metadata.find_max("accuracy", kind="job")
        (workdir / "out/best.json").write_text(
            json.dumps(proj.metadata.get(best) | {"job_id": best}))

    # 1. declare the DAG: ETL -> map sweep -> report. The sweep's edge on
    # ETL and the report handles' ordering need no manual sequencing:
    # TrainSet/model-* dataflow plus after= declare everything.
    pipe = plat.pipeline(admin, name="sweep")
    pipe.stage(JobSpec(
        name="etl", project="", user="", fn=etl_job, args={"device": dev},
        input_fileset="RawDump", output_fileset="TrainSet",
        resources={"vcpu": 1, "mem_mb": 512}))
    sweep = pipe.map(
        lambda p: JobSpec(
            name=f"train-h{p['hidden']}-lr{p['lr']}", project="", user="",
            fn=train_job, input_fileset="TrainSet",
            output_fileset=f"model-h{p['hidden']}-lr{p['lr']}",
            args={**p, "steps": STEPS, "seed": p["hidden"], "device": dev},
            resources={"vcpu": 1, "mem_mb": 512}),
        GRID)
    report = pipe.stage(JobSpec(
        name="report", project="", user="", fn=report_job,
        output_fileset="SweepReport",
        resources={"vcpu": 1, "mem_mb": 256}), after=sweep)

    # 2. run: every stage gets a JobHandle future; resolution is DAG-gated
    handles = pipe.run()
    held = plat.engine(admin).scheduler.held_count()
    print(f"submitted {len(handles)} stages ({held} held on parents)")
    states = pipe.wait(timeout=600)
    print("terminal states:", [s.value for s in states])

    report.handle.result()          # resolves the report stage (or raises)
    best = json.loads(proj.storage.download("/SweepReport/best.json"))
    print(f"best job: {best['job_id']} acc={best['accuracy']:.3f} "
          f"hidden={best['hidden']} lr={best['lr']} cost=${best['cost']:.6f}")

    # 3. provenance reflects the DECLARED dataflow: one edge per DAG edge
    edges = proj.provenance.dependency_edges(pipeline="sweep")
    print(f"declared DAG edges recorded: {len(edges)} "
          f"(1 etl->train x8, train->report x8)")
    registry = plat.engine(admin).registry
    out_ref = registry.get(best["job_id"]).outputs["fileset"]
    print("best model fileset:", out_ref)
    print("derived from:", proj.provenance.backward(out_ref))

    # 4. failure cascade: a broken ETL upstream-fails its whole subtree
    def bad_etl(workdir, job):
        raise RuntimeError("schema drift in raw dump")

    pipe2 = plat.pipeline(admin, name="broken")
    pipe2.stage(JobSpec(name="bad-etl", project="", user="", fn=bad_etl,
                        output_fileset="Clean2"))
    pipe2.map(
        lambda p: JobSpec(name=f"never-{p['i']}", project="", user="",
                          fn=train_job, input_fileset="Clean2"),
        [{"i": 0}, {"i": 1}])
    pipe2.run()
    broken = {h.spec.name: h.wait(timeout=60).value for h in pipe2.handles}
    print("broken pipeline:", broken)
    return {"stages": len(handles), "held": held,
            "states": [s.value for s in states], "best": best,
            "edges": len(edges), "broken": broken,
            "devices": {h.spec.name: registry.get(h.job_id).outputs["device"]
                        for h in sweep}}


if __name__ == "__main__":
    main()
