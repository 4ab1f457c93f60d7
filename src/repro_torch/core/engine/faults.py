"""Deterministic chaos injection for the fault-tolerance layer.

A copy of ``repro/core/engine/faults.py``, with its imports in
``repro_torch.core``.

A :class:`FaultPlan` is a seeded description of the faults a run should
suffer; a :class:`FaultInjector` replays it against a scheduler + virtual
runner on the *virtual clock*, so a chaos scenario is exactly as
reproducible as the fleet it torments. Three fault classes, each an
independent Poisson process (exponential inter-arrival times drawn from
one seeded ``random.Random``):

- **node kills** — a uniformly-drawn up node on a uniformly-drawn pool
  dies (``Scheduler.fail_node``): it leaves packing and capacity, and
  every resident job fails atomically as *transient* (whole gangs — the
  reservation is one unit), flowing the normal retry path;
- **transient job failures** — a uniformly-drawn RUNNING job fails
  transient (``VirtualRunner.fail_running``), modeling flaky
  infrastructure below the node level (NIC resets, container OOM-kill);
- **stragglers** — a uniformly-drawn RUNNING job's remaining work
  stretches by ``straggler_factor`` (``VirtualRunner.slow_running``),
  the failure mode ``JobSpec.timeout_s`` exists to bound.

Determinism: the injector draws from its own ``Random(seed)`` only — it
never reads wall clocks — and every draw is a function of the (plan,
event-loop order) pair, so two runs over the same fleet with the same
plan inject bit-identical fault sequences. With no plan (or a plan whose
rates are all None/0) the injector schedules nothing, and a fleet run
is byte-for-byte the pre-chaos run — the golden-trace gate relies on it.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional

from repro_torch.core.engine.lifecycle import JobState


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded fault schedule. Rates are mean seconds between events on
    the virtual clock (None or <= 0 disables the class). ``start``
    shields warm-up: no fault fires before it. ``max_node_failures``
    bounds the dead-node count so a long run cannot grind the whole
    cluster away."""
    seed: int = 0
    node_mtbf_s: Optional[float] = None       # mean time between node kills
    transient_mtbf_s: Optional[float] = None  # ... transient job failures
    straggler_mtbf_s: Optional[float] = None  # ... straggler slowdowns
    straggler_factor: float = 4.0             # remaining-work stretch
    start: float = 0.0
    max_node_failures: Optional[int] = None


class FaultInjector:
    """Replays a :class:`FaultPlan` against a scheduler + runner.

    Event-loop contract (mirrors ``Scheduler.next_timer``): advance the
    virtual clock to ``min(runner completion, injector.next_event(),
    scheduler.next_timer())``, then call ``advance_to(now)`` — the
    injector applies every fault scheduled at or before ``now`` and
    draws the next arrival for each class. ``events`` accumulates an
    audit log of what was actually applied (skipped draws — no running
    job, no up node — are logged too; they still consume randomness, so
    the schedule stays independent of fleet state)."""

    def __init__(self, plan: FaultPlan, scheduler, runner):
        self.plan = plan
        self.scheduler = scheduler
        self.runner = runner
        self.rng = random.Random(plan.seed)
        self.events: list[dict] = []
        self.node_failures = 0
        now = getattr(runner, "now", 0.0) or 0.0
        t0 = max(now, plan.start)
        self._next = {
            kind: self._draw(t0, mtbf)
            for kind, mtbf in (("node", plan.node_mtbf_s),
                               ("transient", plan.transient_mtbf_s),
                               ("straggler", plan.straggler_mtbf_s))
            if mtbf is not None and mtbf > 0}

    def _draw(self, t: float, mtbf: float) -> float:
        return t + self.rng.expovariate(1.0 / mtbf)

    def next_event(self) -> Optional[float]:
        """Virtual time of the earliest scheduled fault, or None."""
        return min(self._next.values()) if self._next else None

    def advance_to(self, now: float) -> list[dict]:
        """Apply every fault scheduled at or before ``now``; returns the
        newly-applied event records."""
        applied = []
        while self._next:
            kind = min(self._next, key=self._next.get)
            t = self._next[kind]
            if t > now + 1e-9:
                break
            rec = self._apply(kind, t)
            if rec is not None:
                applied.append(rec)
                self.events.append(rec)
            mtbf = {"node": self.plan.node_mtbf_s,
                    "transient": self.plan.transient_mtbf_s,
                    "straggler": self.plan.straggler_mtbf_s}[kind]
            self._next[kind] = self._draw(t, mtbf)
        return applied

    # ------------------------------------------------------------------
    def _running_jobs(self) -> list:
        jobs = [j for j in self.scheduler.registry.all_jobs()
                if j.state == JobState.RUNNING]
        jobs.sort(key=lambda j: j.job_id)       # deterministic draw order
        return jobs

    def _apply(self, kind: str, t: float) -> Optional[dict]:
        if kind == "node":
            cap = self.plan.max_node_failures
            if cap is not None and self.node_failures >= cap:
                self._next.pop("node", None)
                return {"t": t, "kind": "node", "skipped": "cap"}
            targets = []        # (pool, node_idx) over every up node
            for pname in sorted(self.scheduler.pools):
                cl = self.scheduler.pools[pname]
                up = getattr(cl, "up_nodes", None)
                if callable(up):
                    targets.extend((pname, i) for i in up())
            if not targets:
                self.rng.random()       # burn the draw: state-independent
                return {"t": t, "kind": "node", "skipped": "no-up-nodes"}
            pool, idx = targets[self.rng.randrange(len(targets))]
            failed = self.scheduler.fail_node(pool, idx)
            self.node_failures += 1
            return {"t": t, "kind": "node", "pool": pool, "node": idx,
                    "failed_jobs": failed}
        jobs = self._running_jobs()
        if not jobs:
            self.rng.random()
            return {"t": t, "kind": kind, "skipped": "no-running-jobs"}
        job = jobs[self.rng.randrange(len(jobs))]
        if kind == "transient":
            ok = self.runner.fail_running(
                job, error="injected transient fault", transient=True)
            return {"t": t, "kind": "transient", "job": job.job_id,
                    "applied": bool(ok)}
        new_end = self.runner.slow_running(job, self.plan.straggler_factor)
        return {"t": t, "kind": "straggler", "job": job.job_id,
                "factor": self.plan.straggler_factor,
                "new_end": new_end}
