"""Crash recovery: replay snapshot + journal into a live engine.

A copy of ``repro/core/engine/durable/recovery.py``, with its imports in
``repro_torch.core``.

``recover(engine)`` rebuilds the registry, pool capacities and runner
checkpoint progress from the durable store, then re-enters every
non-terminal job through the ordinary ``Scheduler.submit`` path as a
*new epoch* — the PR-5 epoch guards make the crashed incarnation's
stragglers (a zombie worker's late terminal event, a replayed journal
record) recognizably stale, so nothing can double-settle.

Recovery invariants:

1. **No lost jobs** — every journaled ``submit`` yields a registry entry;
   non-terminal ones re-queue (in original submit order, so ``depends_on``
   resolves against already-rebuilt parents) and run to a terminal state.
2. **No duplicated terminal events** — terminal jobs are adopted as-is
   and never re-run; a replayed/duplicate terminal record for a job that
   is already terminal (or for a superseded epoch) is dropped in
   :func:`fold`, and live stragglers are dropped by the epoch guards.
3. **Progress survives** — a preempted job's checkpointed fraction
   (journaled ``progress`` records) is restored into the runner before
   the requeue, so the relaunch resumes from the checkpoint, exactly as
   a live preemption would.
4. **Workers outlive the engine** — when the launcher is a
   :class:`SubprocessRunner`, its worker process is re-adopted: results
   it buffered while the engine was down apply as terminals (no re-run),
   and jobs still in flight re-attach at their original epoch instead of
   re-queueing.

Recording is paused for the duration (rebuilding from the journal must
not re-journal the rebuild); a fresh compacted snapshot is written at
the end, so a second crash recovers from clean state.
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import Optional

from repro_torch.core.engine.durable.codec import decode_job, encode_job, \
    json_safe
from repro_torch.core.engine.lifecycle import TERMINAL_STATES, JobState

_TERMINAL_VALUES = frozenset(s.value for s in TERMINAL_STATES)


@dataclasses.dataclass
class RecoveryReport:
    jobs_total: int = 0
    terminal: int = 0           # adopted as-is, never re-run
    requeued: int = 0           # non-terminal: re-entered as new epochs
    adopted: int = 0            # still in flight on a surviving worker
    worker_results: int = 0     # completed while the engine was down
    resumed: int = 0            # requeues restored from a checkpoint
    events_replayed: int = 0
    wall_s: float = 0.0


# -- snapshot construction ----------------------------------------------
def snapshot_state(engine) -> dict:
    """Full-state snapshot document: every job, the id counter, runner
    checkpoint progress, and live pool capacities (elastic resizes must
    survive the restart)."""
    registry = engine.registry
    doc: dict = {"v": 1, "ctr": registry._ctr,
                 "jobs": [encode_job(j) for j in registry.all_jobs()]}
    prog_fn = getattr(engine.launcher, "checkpoint_progress", None)
    if callable(prog_fn):
        prog = {jid: f for jid, f in prog_fn().items() if f}
        if prog:
            doc["progress"] = prog
    pools = getattr(engine.scheduler, "pools", None) or {}
    if pools:
        doc["pools"] = {name: json_safe(cl.capacity)
                        for name, cl in pools.items()}
    return doc


# -- journal fold --------------------------------------------------------
def fold(snapshot: Optional[dict],
         events: list[dict]) -> tuple[dict, dict, dict]:
    """Fold snapshot + journal into per-job records with idempotent apply
    semantics: records carry absolute states and epochs, stale-epoch
    records and duplicate terminals are dropped. Returns
    ``(job docs by id, pool capacities, checkpoint progress)``."""
    records: dict[str, dict] = {}
    pools: dict[str, dict] = {}
    progress: dict[str, float] = {}
    if snapshot:
        for doc in snapshot.get("jobs", ()):
            records[doc["job_id"]] = dict(doc)
        pools.update(snapshot.get("pools", {}))
        progress.update(snapshot.get("progress", {}))
    for ev in events:
        t = ev.get("t")
        if t == "submit":
            jid = ev["job"]
            if jid in records:
                continue        # replayed submit: idempotent
            records[jid] = {"job_id": jid, "spec": ev["spec"],
                            "state": "SUBMITTED",
                            "submitted_at": ev.get("at"),
                            "epoch": 0, "preemptions": 0, "outputs": {}}
        elif t == "state":
            rec = records.get(ev["job"])
            if rec is None:
                continue
            if int(ev.get("epoch", 0)) < int(rec.get("epoch", 0)):
                continue        # superseded incarnation's write: stale
            if rec.get("state") in _TERMINAL_VALUES:
                # one refinement is legal out of a terminal: FAILED ->
                # QUARANTINED (the crash-loop verdict lands after the
                # failure's own terminal record); everything else is a
                # duplicate terminal for a settled job
                if not (ev["state"] == JobState.QUARANTINED.value and
                        rec.get("state") == JobState.FAILED.value):
                    continue
            rec["state"] = ev["state"]
            rec["epoch"] = int(ev.get("epoch", 0))
            if ev.get("pool") is not None:
                rec["pool"] = ev["pool"]
            if ev.get("error") is not None:
                rec["error"] = ev["error"]
            for field in ("finished_at", "runtime", "cost"):
                if ev.get(field) is not None:
                    rec[field] = ev[field]
        elif t == "preempt":
            rec = records.get(ev["job"])
            if rec is None or rec.get("state") in _TERMINAL_VALUES:
                continue
            if int(ev.get("epoch", 0)) <= int(rec.get("epoch", 0)):
                continue        # replayed bump: the epoch already moved
            rec["epoch"] = int(ev["epoch"])
            rec["preemptions"] = int(ev.get("preemptions",
                                            rec.get("preemptions", 0)))
            rec["state"] = JobState.PREEMPTED.value
        elif t == "retry":
            rec = records.get(ev["job"])
            if rec is None:
                continue
            if int(ev.get("epoch", 0)) <= int(rec.get("epoch", 0)):
                continue        # replayed rebirth: the epoch already moved
            # epoch rebirth out of FAILED: unlike every other record this
            # deliberately overrides a terminal state — the retry budget
            # resurrected the job, and the counters must survive so a
            # recovered engine doesn't grant a crash-looper a fresh budget
            rec["state"] = JobState.QUEUED.value
            rec["epoch"] = int(ev["epoch"])
            rec["retries"] = int(ev.get("retries",
                                        rec.get("retries", 0) + 1))
            rec["failures"] = int(ev.get("failures",
                                         rec.get("failures", 0)))
            rec["finished_at"] = None
            if ev.get("error") is not None:
                rec["error"] = ev["error"]
        elif t == "progress":
            progress[ev["job"]] = float(ev.get("done_frac", 0.0))
        elif t == "final":
            rec = records.get(ev["job"])
            if rec is None:
                continue
            if int(ev.get("epoch", 0)) < int(rec.get("epoch", 0)):
                continue
            rec["state"] = ev.get("state", rec.get("state"))
            rec["epoch"] = int(ev.get("epoch", rec.get("epoch", 0)))
            for field in ("runtime", "cost", "error"):
                if ev.get(field) is not None:
                    rec[field] = ev[field]
            if ev.get("outputs"):
                rec["outputs"] = ev["outputs"]
        elif t == "resize":
            pools[ev["pool"]] = ev.get("capacity", {})
    return records, pools, progress


def _idnum(job_id: str) -> tuple:
    m = re.fullmatch(r"job-(\d+)", job_id)
    return (0, int(m.group(1))) if m else (1, job_id)


# -- recovery entry ------------------------------------------------------
def recover(engine) -> RecoveryReport:
    """Replay the engine's durable store into its live scheduler/registry
    (see the module docstring for the invariants). Returns a report;
    requeued jobs still need the engine driven (``wait_all`` / handle
    waits) to reach terminal states."""
    t0 = time.perf_counter()
    journal = engine.journal
    registry, scheduler = engine.registry, engine.scheduler
    launcher = engine.launcher
    snap, events = journal.load()
    records, pools, progress = fold(snap, events)
    report = RecoveryReport(jobs_total=len(records),
                            events_replayed=len(events))
    with journal.paused():
        for name, cap in pools.items():
            cl = scheduler.pools.get(name)
            if cl is not None:
                scheduler.resize_pool(name, {n: float(v)
                                             for n, v in cap.items()})
        order = sorted(records.values(),
                       key=lambda d: _idnum(d["job_id"]))
        for doc in order:
            registry.adopt(decode_job(doc))
        # process-boundary runner: re-adopt the surviving worker before
        # deciding requeues — its buffered results and in-flight set
        # reclassify jobs the journal last saw as RUNNING
        inflight: dict[str, int] = {}
        results: list[dict] = []
        adopt_fn = getattr(launcher, "adopt", None)
        if callable(adopt_fn):
            inflight, results = adopt_fn()
        apply_fn = getattr(launcher, "apply_result", None)
        for msg in results:
            try:
                job = registry.get(msg.get("job", ""))
            except KeyError:
                continue
            if job.state in TERMINAL_STATES or not callable(apply_fn):
                continue        # duplicate of a journaled terminal: drop
            ep = msg.get("epoch")
            if ep is not None and int(ep) == job.epoch and \
                    job.state not in (JobState.RUNNING, JobState.PREEMPTED):
                # the worker's durable record proves this incarnation
                # reached RUNNING even if the journal lost the state
                # records; reconstruct that step so the terminal applies
                job.state = JobState.RUNNING
            if apply_fn(job, msg, publish=False):
                report.worker_results += 1
                engine.monitor.record_status(job.job_id, job.state.value)
        restore = getattr(launcher, "restore_progress", None)
        for doc in order:
            job = registry.get(doc["job_id"])
            if job.state in TERMINAL_STATES:
                report.terminal += 1
                engine.monitor.record_status(job.job_id, job.state.value,
                                             overwrite=False)
                continue
            if inflight.get(job.job_id) == job.epoch and \
                    job.state in (JobState.RUNNING, JobState.LAUNCHING):
                scheduler.adopt_running(job)
                report.adopted += 1
                continue
            frac = progress.get(job.job_id)
            if frac and callable(restore):
                restore(job.job_id, frac)
                report.resumed += 1
            # re-enter as a fresh incarnation: the epoch bump makes any
            # straggler of the crashed run (zombie worker, replayed
            # record) recognizably stale
            job.state = JobState.SUBMITTED
            job.epoch += 1
            job.started_at = None
            job.finished_at = None
            job.pool = None
            job.gang_pods = None
            scheduler.submit(job)
            report.requeued += 1
    journal.snapshot()      # compacted base: a second crash starts clean
    report.wall_s = time.perf_counter() - t0
    return report
