"""Crash drill: a deterministic virtual fleet for kill -9 recovery runs.

A copy of ``repro/core/engine/durable/drill.py``, with its imports in
``repro_torch.core``.

The ROADMAP exit criterion for the durable control plane: *kill -9 the
engine mid-fleet, restart, and the golden trace still completes with no
lost or duplicated jobs*. This module is that drill, shared by the bench
scenario (``bench_scheduler.py --smoke``) and the integration tests:

* :func:`run_fresh` builds a durable virtual engine, submits a seeded
  fleet (mixed durations/priorities/resource shapes, dependency chains
  for held jobs, near-capacity jobs plus a mid-run elastic shrink so
  preemptions/epochs are exercised) and drives it to completion,
  heart-beating progress to ``<dir>/progress`` so a parent process can
  choose its kill moment.
* :func:`resume` rebuilds the engine from the same state directory
  (recovery runs in the constructor), drains the re-queued fleet, and
  reports final states plus duplicate-terminal counts.

Run as a module for the subprocess-victim side::

    python -m repro_torch.core.engine.durable.drill --dir <d> --n-jobs 800

The process submits (or recovers) and drives the fleet, then writes
``<d>/final.json`` — SIGKILL it anywhere in between.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import random
import sys
from pathlib import Path

from repro_torch.core.acai import AcaiEngine
from repro_torch.core.engine.events import TOPIC_CONTAINER_STATUS
from repro_torch.core.engine.lifecycle import TERMINAL_STATUS_VALUES
from repro_torch.core.engine.registry import JobSpec
from repro_torch.core.provision.pricing import CPU_PRICING

NODES = 4                   # vcpu capacity 32, mem 32 GiB
BIG_VCPU = 24               # near-capacity: starves behind small jobs
SHRUNK_VCPU = 26.0          # mid-run shrink: > BIG_VCPU so nothing goes
FULL_VCPU = 32.0            # infeasible, but running work must drain


def build_engine(state_dir: str | Path) -> AcaiEngine:
    """The drill's engine: durable virtual runner with preemption +
    checkpointing on. Building over an existing state dir recovers."""
    return AcaiEngine(
        virtual=True, pricing=CPU_PRICING, cluster_nodes=NODES,
        quota_k=8, policy="fair", backfill=True,
        preemption=True, starvation_threshold=20.0,
        checkpoint_interval=30.0,
        durable=state_dir, snapshot_every=1500)


def make_fleet(n_jobs: int, seed: int) -> list[JobSpec]:
    rng = random.Random(seed)
    specs = []
    for i in range(n_jobs):
        if i % 31 == 17:
            # near-capacity high-priority job: starves, then preempts
            res = {"vcpu": float(BIG_VCPU), "mem_mb": 2048.0}
            prio, dur = 5, rng.uniform(20.0, 60.0)
        else:
            res = {"vcpu": float(rng.choice([1, 2, 4])), "mem_mb": 512.0}
            prio = rng.choice([0, 0, 0, 1, 2])
            dur = rng.uniform(5.0, 120.0)
        deps = [f"job-{i}"] if (i % 7 == 3 and i > 0) else []
        specs.append(JobSpec(
            name=f"drill-{i}", project="drill", user="u",
            duration=round(dur, 3), priority=prio, resources=res,
            depends_on=deps, args={"checkpoint_interval": 30.0}))
    return specs


def _drive(engine: AcaiEngine, n_jobs: int,
           heartbeat: Path | None = None) -> None:
    """Drain the virtual clock, applying the drill's deterministic
    elastic events (shrink at 10% completions, restore at 20%) and
    heart-beating completion counts for an external killer."""
    launcher = engine.scheduler.launcher
    pool = next(iter(engine.scheduler.pools))
    shrunk = restored = False
    while launcher.pending() > 0:
        launcher.step()
        done = engine.scheduler.stats["completed"]
        if not shrunk and done >= n_jobs // 10:
            engine.scheduler.resize_pool(pool, {"vcpu": SHRUNK_VCPU})
            shrunk = True
        elif shrunk and not restored and done >= n_jobs // 5:
            engine.scheduler.resize_pool(pool, {"vcpu": FULL_VCPU})
            restored = True
        if heartbeat is not None and done % 25 == 0:
            heartbeat.write_text(str(done))
    if heartbeat is not None:
        heartbeat.write_text(str(engine.scheduler.stats["completed"]))


def final_states(engine: AcaiEngine) -> dict[str, str]:
    return {j.job_id: j.state.value for j in engine.registry.all_jobs()}


def run_fresh(dirpath: str | Path, n_jobs: int = 800,
              seed: int = 7) -> dict[str, str]:
    """Submit the seeded fleet into a fresh durable engine and drive it
    to completion; returns the final {job_id: state} map."""
    d = Path(dirpath)
    d.mkdir(parents=True, exist_ok=True)
    engine = build_engine(d / "state")
    for spec in make_fleet(n_jobs, seed):
        engine.submit(spec)
    _drive(engine, n_jobs, heartbeat=d / "progress")
    final = final_states(engine)
    (d / "final.json").write_text(json.dumps(final, sort_keys=True))
    return final


def resume(dirpath: str | Path, n_jobs: int, seed: int = 7) -> dict:
    """Recover the engine from ``<dir>/state`` and drain what the crash
    left behind. Returns final states, the recovery report, duplicate
    terminal-event counts, and the release-underflow total (any
    double-settle would move it off zero)."""
    d = Path(dirpath)
    engine = build_engine(d / "state")
    if not engine.registry.all_jobs():      # killed before any submit
        for spec in make_fleet(n_jobs, seed):
            engine.submit(spec)
    terminal_seen: dict[str, int] = {}

    def _count(msg: dict) -> None:
        if msg.get("status", "") in TERMINAL_STATUS_VALUES:
            jid = msg["job_id"]
            terminal_seen[jid] = terminal_seen.get(jid, 0) + 1

    engine.bus.subscribe(TOPIC_CONTAINER_STATUS, _count)
    _drive(engine, n_jobs, heartbeat=d / "progress")
    final = final_states(engine)
    (d / "final.json").write_text(json.dumps(final, sort_keys=True))
    report = getattr(engine, "recovery", None)
    underflow = sum(cl.stats.get("release_underflow", 0)
                    for cl in engine.scheduler.pools.values())
    return {
        "final": final,
        "report": dataclasses.asdict(report) if report else None,
        "duplicate_terminals": {j: c for j, c in terminal_seen.items()
                                if c > 1},
        "release_underflow": underflow,
        "completed_after_recovery": engine.scheduler.stats["completed"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="acai-crash-drill")
    ap.add_argument("--dir", required=True)
    ap.add_argument("--n-jobs", type=int, default=800)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    d = Path(args.dir)
    state = d / "state"
    if state.exists() and any(state.iterdir()):
        out = resume(d, args.n_jobs, args.seed)
        print(json.dumps({"resumed": True,
                          "report": out["report"],
                          "duplicates": len(out["duplicate_terminals"])}))
    else:
        run_fresh(d, args.n_jobs, args.seed)
        print(json.dumps({"resumed": False}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
