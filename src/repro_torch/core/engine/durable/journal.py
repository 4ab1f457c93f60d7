"""Write-ahead journal: every state-changing engine event, durably.

A copy of ``repro/core/engine/durable/journal.py``, with its imports in
``repro_torch.core``.

The journal is an append-only stream of JSON records in a
:class:`~repro_torch.core.engine.durable.store.StateStore`, compacted
periodically into a whole-state snapshot key. Event types:

``submit``    a job entered the registry (full encoded spec)
``state``     a registry state transition (state, epoch, pool, error,
              runtime/cost as known at that instant)
``preempt``   an epoch bump (``mark_preempted``): the prior incarnation
              is superseded from this record on
``retry``     an epoch rebirth (``mark_retrying``): a FAILED incarnation
              re-queued under its retry budget, with the retry/failure
              counters that must survive a restart
``progress``  checkpointed progress banked by a preemption (fraction of
              the job done — a relaunch resumes from here)
``final``     terminal enrichment recorded after the runner finished
              settling (authoritative outputs/runtime/cost — the
              ``state`` event fires before the runner commits them)
``resize``    a pool's capacity changed (elastic resize / spot reclaim)

Every record carries a monotone sequence number ``n`` assigned by the
journal (never reset by compaction), so replay after a crash *between*
snapshot write and journal truncation skips the already-snapshotted
prefix instead of double-applying it. Apply semantics are idempotent by
construction — records carry absolute states and epochs, and recovery
drops stale-epoch and duplicate-terminal records — so at-least-once
journal delivery yields exactly-once state.

The registry, launcher and scheduler call the typed ``job_*``/``pool_*``
hooks through a duck-typed optional attribute; with no journal attached
every hook site is a single ``is None`` test.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Optional

from repro_torch.core.engine.durable.codec import encode_spec, json_safe
from repro_torch.core.engine.durable.store import StateStore
from repro_torch.core.engine.events import TOPIC_CONTAINER_STATUS
from repro_torch.core.engine.lifecycle import (TERMINAL_STATES,
                                               TERMINAL_STATUS_VALUES)

JOURNAL_STREAM = "journal"
SNAPSHOT_KEY = "snapshot"


class Journal:
    def __init__(self, store: StateStore, *, snapshot_every: int = 1000):
        self.store = store
        self.snapshot_every = snapshot_every
        # the engine wires this to a callable building the full-state
        # snapshot document (registry + runner progress + pool capacities)
        self.snapshot_source: Optional[Callable[[], dict]] = None
        self._lock = threading.RLock()
        self._next = 1          # next sequence number to assign
        self._since_snap = 0
        self._paused = 0
        self._loaded = False

    # -- low-level record/replay ----------------------------------------
    def record(self, rec: dict) -> None:
        with self._lock:
            if self._paused:
                return
            rec = dict(rec)
            rec["n"] = self._next
            self._next += 1
            self.store.append(JOURNAL_STREAM, rec)
            self._since_snap += 1
            if (self.snapshot_every and self.snapshot_source is not None
                    and self._since_snap >= self.snapshot_every):
                self.snapshot()

    def load(self) -> tuple[Optional[dict], list[dict]]:
        """(snapshot document or None, journal events after it) — and
        prime the sequence counter past everything seen, so records
        appended after recovery never collide with replayed ones."""
        with self._lock:
            snap = self.store.get(SNAPSHOT_KEY)
            watermark = int(snap.get("seq", 0)) if snap else 0
            events = [e for e in self.store.read(JOURNAL_STREAM)
                      if int(e.get("n", 0)) > watermark]
            top = max([watermark] + [int(e.get("n", 0)) for e in events])
            self._next = max(self._next, top + 1)
            self._loaded = True
            return snap, events

    def has_state(self) -> bool:
        """True when the store holds anything to recover from."""
        return (self.store.get(SNAPSHOT_KEY) is not None
                or bool(self.store.read(JOURNAL_STREAM)))

    def snapshot(self) -> None:
        """Compact: write the full-state snapshot, then truncate the
        journal. Crash-ordered — the snapshot (with its ``seq``
        watermark) lands atomically first, so a crash before the truncate
        merely replays records the watermark filter already skips."""
        with self._lock:
            if self.snapshot_source is None:
                return
            doc = self.snapshot_source()
            doc["seq"] = self._next - 1
            self.store.put(SNAPSHOT_KEY, doc)
            self.store.truncate(JOURNAL_STREAM)
            self._since_snap = 0

    @contextmanager
    def paused(self):
        """Suppress recording (recovery rebuilds live state from the
        journal — re-journaling the rebuild would double every event)."""
        with self._lock:
            self._paused += 1
        try:
            yield
        finally:
            with self._lock:
                self._paused -= 1

    # -- typed hooks (called by registry/launcher/scheduler) ------------
    def job_submitted(self, job) -> None:
        self.record({"t": "submit", "job": job.job_id,
                     "at": job.submitted_at, "spec": encode_spec(job.spec)})

    def job_state(self, job) -> None:
        rec = {"t": "state", "job": job.job_id, "state": job.state.value,
               "epoch": job.epoch, "pool": job.pool}
        if job.error is not None:
            rec["error"] = str(job.error)
        if job.state in TERMINAL_STATES:
            rec["finished_at"] = job.finished_at
            rec["runtime"] = job.runtime
            rec["cost"] = job.cost
        self.record(rec)

    def job_preempted(self, job) -> None:
        self.record({"t": "preempt", "job": job.job_id, "epoch": job.epoch,
                     "preemptions": job.preemptions})

    def job_retried(self, job) -> None:
        """Epoch rebirth of a FAILED job under its retry budget: the
        prior incarnation's terminal records are superseded from here,
        and the retry/failure counters survive a restart (a recovered
        engine must not grant a crash-looper a fresh budget)."""
        self.record({"t": "retry", "job": job.job_id, "epoch": job.epoch,
                     "retries": job.retries, "failures": job.failures,
                     "error": job.error})

    def job_progress(self, job_id: str, done_frac: float) -> None:
        self.record({"t": "progress", "job": job_id,
                     "done_frac": float(done_frac)})

    def pool_resized(self, pool: str, capacity: dict) -> None:
        self.record({"t": "resize", "pool": pool,
                     "capacity": json_safe(capacity)})

    def job_final(self, job) -> None:
        """Terminal enrichment: runner settles outputs/cost *after* the
        epoch-guarded terminal state write, so the authoritative values
        are journaled from the bus event that closes the settle."""
        self.record({"t": "final", "job": job.job_id,
                     "state": job.state.value, "epoch": job.epoch,
                     "runtime": job.runtime, "cost": job.cost,
                     "error": job.error,
                     "outputs": json_safe(job.outputs)})


def terminal_recorder(journal: Journal, registry) -> Callable[[dict], None]:
    """Bus handler journaling a ``final`` record per terminal
    container_status. Subscribe it *after* the scheduler (handlers run in
    subscription order): by then the runner's finalize has committed
    outputs and billing, so the record carries final values."""
    def _on_status(msg: dict) -> None:
        if msg.get("status", "") not in TERMINAL_STATUS_VALUES:
            return
        try:
            job = registry.get(msg["job_id"])
        except KeyError:
            return
        if job.state not in TERMINAL_STATES:
            return      # stale event for a superseded (re-queued) epoch
        journal.job_final(job)
    return _on_status


def attach_terminal_recorder(bus, journal: Journal, registry) -> None:
    bus.subscribe(TOPIC_CONTAINER_STATUS, terminal_recorder(journal,
                                                            registry))
