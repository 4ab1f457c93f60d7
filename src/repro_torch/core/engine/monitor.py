"""Job monitor + log server (ACAI §4.2): subscribes to all bus topics,
keeps per-job latest status, progress stage and log tail; the dashboard's
WebSocket feed becomes the ``watch`` API. With the capacity scheduler it
also records cluster-utilization snapshots (``scheduler_metrics`` topic),
so queue pressure and capacity holes are observable over (virtual) time.

A copy of ``repro/core/engine/monitor.py``, with its imports
in ``repro_torch.core``.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Optional

from repro_torch.core.engine.events import (EventBus, TOPIC_CONTAINER_STATUS,
                                            TOPIC_JOB_PROGRESS,
                                            TOPIC_SCHEDULER)
from repro_torch.core.engine.lifecycle import TERMINAL_STATUS_VALUES as \
    _TERMINAL_STATUS


class JobMonitor:
    def __init__(self, bus: EventBus, *, registry=None,
                 max_samples: int = 10_000):
        # with a registry attached, terminal checks fall back to the
        # job's registry state — a job that went terminal before this
        # monitor subscribed (recovered engine, cross-process handle)
        # still resolves instead of hanging its waiters
        self.registry = registry
        self.status: dict[str, str] = {}  # guarded-by: _lock
        self.stage: dict[str, str] = {}  # guarded-by: _lock
        self.events: dict[str, list[dict]] = defaultdict(list)  # guarded-by: _lock
        self.cluster_samples: list[dict] = []  # guarded-by: _lock
        self.max_samples = max_samples
        # running aggregates at ingest: the sample buffer is trimmed, so
        # peak/mean must not be recomputed from it. samples_seen counts
        # every snapshot ever received (the scheduler coalesces them
        # behind a change gate + snapshot_interval, so cadence is a
        # deployment knob worth observing), and last_sample_at is the
        # runner-clock time of the freshest one
        self._peak: dict[str, float] = {}  # guarded-by: _lock
        self._util_sum: dict[str, float] = defaultdict(float)  # guarded-by: _lock
        self._util_n = 0  # guarded-by: _lock
        self.samples_seen = 0  # guarded-by: _lock
        self.last_sample_at: Optional[float] = None  # guarded-by: _lock
        # handlers run on whichever thread publishes (worker finalize,
        # virtual-clock step, scheduler snapshot), so every mutable map
        # and aggregate above is guarded; never publish from under it —
        # the bus is synchronous and would re-enter the handlers
        self._lock = threading.RLock()  # acailint: lock(forbid: publish)
        # JobHandle.wait blocks on this instead of polling: any terminal
        # container_status wakes every waiter, each re-checks its own
        # job. Lock order: _lock may be taken under the cv (the wait
        # predicate), so notifiers must NEVER hold _lock when taking the
        # cv — release first, then notify
        self._terminal_cv = threading.Condition()
        # the port's addition: job_id -> epoch of the last terminal event
        # accepted from the bus (see ``published``)
        self._published: dict[str, int] = {}  # guarded-by: _lock
        bus.subscribe(TOPIC_CONTAINER_STATUS, self._on_status)
        bus.subscribe(TOPIC_JOB_PROGRESS, self._on_progress)
        bus.subscribe(TOPIC_SCHEDULER, self._on_scheduler)

    def _on_status(self, msg: dict) -> None:
        status = msg.get("status", "")
        terminal = status in _TERMINAL_STATUS
        job = None
        with self._lock:
            if terminal and self.registry is not None:
                # handlers run in subscription order: the scheduler
                # (first) may have already retried this FAILED
                # incarnation — the registry epoch moved past the
                # message's, so caching the terminal here would wake
                # waiters on a job that is alive again. Keep the event
                # for watch(), drop the status.
                try:
                    job = self.registry.get(msg["job_id"])
                except KeyError:
                    job = None
                if job is not None and \
                        int(msg.get("epoch", job.epoch)) < job.epoch:
                    self.events[msg["job_id"]].append(msg)
                    return
                if job is not None:
                    # accepted terminal: the retry decision (if any) is
                    # made — backstop for engines with no scheduler
                    # subscribed
                    job.retry_pending = False
            self.status[msg["job_id"]] = status
            self.events[msg["job_id"]].append(msg)
            if terminal:
                self._published[msg["job_id"]] = int(msg.get(
                    "epoch", job.epoch if job is not None else 0))
        # notify with _lock released: the wait predicate takes _lock
        # under the cv, so notifying while holding _lock would deadlock
        if terminal:
            with self._terminal_cv:
                self._terminal_cv.notify_all()

    def record_status(self, job_id: str, status: str,
                      overwrite: bool = True) -> None:
        """Seed the cached status map directly (crash recovery replays
        terminal outcomes before any bus traffic exists). With
        ``overwrite=False`` an already-cached status wins — the replay
        of older records must not clobber a fresher worker result."""
        with self._lock:
            if overwrite:
                self.status[job_id] = status
            else:
                self.status.setdefault(job_id, status)

    def is_terminal(self, job_id: str) -> bool:
        with self._lock:
            if self.status.get(job_id, "") in _TERMINAL_STATUS:
                return True
        if self.registry is not None:
            try:
                job = self.registry.get(job_id)
            except KeyError:
                return False
            state = job.state.value
            if state in _TERMINAL_STATUS and not job.retry_pending:
                # cache it so the wait predicate stays cheap and watch()
                # consumers see a consistent status map
                with self._lock:
                    self.status.setdefault(job_id, state)
                return True
        return False

    def published(self, job_id: str, epoch: int) -> bool:
        """Whether incarnation ``epoch`` of ``job_id`` has published its
        terminal container_status. A worker thread publishes it last,
        after its outputs, log, bill and metadata are committed, while
        the registry shows the terminal state before those: the
        reference's handles resolve on the registry state, so on the
        thread runner ``result()`` and ``logs()`` could read them empty
        (ROADMAP C)."""
        with self._lock:
            return self._published.get(job_id, -1) >= epoch

    def wait_published(self, job_id: str, epoch: int,
                       timeout: Optional[float] = None) -> bool:
        """Block until ``published(job_id, epoch)`` (True) or the timeout
        elapses (False)."""
        with self._terminal_cv:
            return self._terminal_cv.wait_for(
                lambda: self.published(job_id, epoch), timeout)

    def wait_terminal(self, job_id: str,
                      timeout: Optional[float] = None) -> bool:
        """Block until ``job_id`` publishes a terminal container_status
        (True) or the timeout elapses (False). Event-driven: used by
        JobHandle.wait for runners that complete on worker threads."""
        with self._terminal_cv:
            return self._terminal_cv.wait_for(
                lambda: self.is_terminal(job_id), timeout)

    def _on_progress(self, msg: dict) -> None:
        with self._lock:
            self.stage[msg["job_id"]] = msg.get("stage", "")
            self.events[msg["job_id"]].append(msg)

    def _on_scheduler(self, msg: dict) -> None:
        with self._lock:
            self.cluster_samples.append(msg)
            self.samples_seen += 1
            self.last_sample_at = msg.get("now", self.last_sample_at)
            util = msg.get("utilization", {})
            if util:
                self._util_n += 1
                for dim, u in util.items():
                    self._peak[dim] = max(self._peak.get(dim, 0.0), u)
                    self._util_sum[dim] += u
            if len(self.cluster_samples) > self.max_samples:
                del self.cluster_samples[:len(self.cluster_samples) // 2]

    def watch(self, job_id: str) -> list[dict]:
        with self._lock:
            return list(self.events[job_id])

    # -- utilization over (virtual) time --------------------------------
    def peak_utilization(self) -> dict[str, float]:
        with self._lock:
            return dict(self._peak)

    def mean_utilization(self) -> dict[str, float]:
        with self._lock:
            if not self._util_n:
                return {}
            return {d: v / self._util_n
                    for d, v in self._util_sum.items()}

    def utilization_summary(self) -> tuple[bool, dict[str, float],
                                           dict[str, float]]:
        """``(has samples, peak, mean)`` in one lock hold, so both
        aggregates come from the same ingest point — the dashboard must
        not interleave its reads with a concurrent ``_on_scheduler``."""
        with self._lock:
            has = bool(self.cluster_samples)
            peak = dict(self._peak)
            mean = {} if not self._util_n else \
                {d: v / self._util_n for d, v in self._util_sum.items()}
        return has, peak, mean

    def utilization_by_pool(self) -> dict[str, dict[str, dict[str, float]]]:
        """``{pool: {dim: {"mean": m, "peak": p}}}`` — multi-pool
        snapshots namespace utilization keys as ``"<pool>/<dim>"``; flat
        keys (single default pool) land under ``"default"``."""
        with self._lock:
            mean = {} if not self._util_n else \
                {d: v / self._util_n for d, v in self._util_sum.items()}
            out: dict[str, dict[str, dict[str, float]]] = {}
            for key, peak in self._peak.items():
                pool, _, dim = key.rpartition("/")
                out.setdefault(pool or "default", {})[dim or key] = {
                    "mean": mean.get(key, 0.0), "peak": peak}
            return out
