"""Job registry (ACAI §4.2): repository of submitted jobs + metadata.

A copy of ``repro/core/engine/registry.py``, with its imports
in ``repro_torch.core``.
"""
from __future__ import annotations

import dataclasses
import re
import threading
import time
from typing import Any, Callable, Optional

from repro_torch.core.engine.lifecycle import (TERMINAL_STATES,
                                               IllegalTransition, JobState,
                                               check_transition)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry budget for a job that ends FAILED (ACAI robustness layer).

    A retryable failure requeues the job as a new ``Job.epoch`` (the same
    rebirth machinery preemption uses) after an exponential backoff hold
    of ``min(backoff_cap, backoff_base * 2**retries)`` seconds.
    ``retry_on="transient"`` retries only failures the runner classified
    transient (``TransientJobError``, node loss, worker death);
    ``"any"`` also retries ordinary exceptions — those count toward the
    scheduler's crash-loop quarantine threshold, so a deterministic bug
    ends QUARANTINED instead of burning the whole budget.
    """
    max_retries: int = 3
    backoff_base: float = 1.0
    backoff_cap: float = 60.0
    retry_on: str = "transient"                # "transient" | "any"

    def backoff(self, retries: int) -> float:
        """Hold before retry number ``retries + 1`` (0-based exponent)."""
        return min(self.backoff_cap, self.backoff_base * (2.0 ** retries))


@dataclasses.dataclass(frozen=True)
class GangSpec:
    """A co-scheduled group of identical pods (sharded multi-host training).

    ``n_pods`` pods launch atomically on one pool — all or none; the
    scheduler admits/backfills/shadows the gang as a single unit and a
    preemption of any pod preempts the whole gang with one epoch bump.
    ``per_pod_resources`` defaults to the spec's ``resources`` (the spec's
    resources then describe ONE pod, and the gang is charged
    ``n_pods x per_pod``). ``topology`` is a placement hint: ``"close"``
    asks for all pods on one interconnect island — pools that cannot host
    the gang close are penalized by the transfer-cost model, not rejected.
    ``min_pods`` > 0 marks the gang resizable: under capacity pressure
    (spot reclaim, elastic shrink) the engine may shrink it to any
    k >= min_pods instead of preempting it outright.
    """
    n_pods: int
    per_pod_resources: Optional[dict] = None
    topology: str = "any"                      # "any" | "close"
    min_pods: int = 0                          # 0 => not resizable

    def pod_resources(self, spec: "JobSpec") -> dict:
        res = self.per_pod_resources
        return dict(res if res is not None else spec.resources)


@dataclasses.dataclass
class JobSpec:
    """Encapsulation of an ML program (ACAI §3: the Job abstraction)."""
    name: str
    project: str
    user: str
    # the program: a python callable fn(workdir: Path, job: Job) -> dict
    # (the paper runs argv in a container; the runner interface is pluggable)
    fn: Optional[Callable] = None
    argv: Optional[list[str]] = None
    input_fileset: Optional[str] = None
    output_fileset: Optional[str] = None     # name for the output file set
    resources: dict[str, Any] = dataclasses.field(default_factory=dict)
    args: dict[str, Any] = dataclasses.field(default_factory=dict)
    # virtual-duration hook for simulated runs (profiling experiments)
    duration: Optional[float] = None
    # scheduling priority (added to the queue's priority; higher first)
    priority: int = 0
    # declared dataflow: job ids that must FINISH before this job launches.
    # The scheduler holds the job until every parent is FINISHED and
    # cascades UPSTREAM_FAILED if any parent ends FAILED/KILLED.
    depends_on: list[str] = dataclasses.field(default_factory=list)
    # heterogeneous pools: pin to one pool by name; declare per-pool
    # resource alternatives (an explicit menu placement chooses from —
    # when set, the job is eligible only on the listed pools); name the
    # profiled command template whose model predicts this job's runtime
    # so placement can score pools on the cost/speed frontier.
    pool: Optional[str] = None
    pool_resources: dict[str, dict[str, Any]] = \
        dataclasses.field(default_factory=dict)
    template: Optional[str] = None
    # gang scheduling: co-launch n_pods pods as one atomic unit (None =
    # ordinary single-reservation job; see GangSpec)
    gang: Optional[GangSpec] = None
    # declared size of this job's input fileset in bytes — the placement
    # layer's transfer-cost model prices moving these bytes between
    # accelerator families when a child lands off its parent's pool
    input_bytes: float = 0.0
    # fault tolerance (None = fail-fast, the pre-retry behaviour):
    # requeue budget for FAILED incarnations, per-incarnation runtime
    # limit (a timed-out incarnation fails *transient* — straggler
    # semantics — so the retry budget can try it elsewhere), and an
    # end-to-end deadline in seconds after submit (the job is killed at
    # the deadline, and rejected at admission when its declared duration
    # already proves the deadline infeasible on every pool)
    retry: Optional[RetryPolicy] = None
    timeout_s: Optional[float] = None
    deadline: Optional[float] = None

    @property
    def n_pods(self) -> int:
        return self.gang.n_pods if self.gang is not None else 1


@dataclasses.dataclass
class Job:
    job_id: str
    spec: JobSpec
    state: JobState = JobState.SUBMITTED
    submitted_at: float = dataclasses.field(default_factory=time.time)
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    runtime: Optional[float] = None          # measured (or virtual) seconds
    cost: Optional[float] = None             # accumulated across segments
    pool: Optional[str] = None               # the pool placement launched on
    error: Optional[str] = None
    outputs: dict[str, Any] = dataclasses.field(default_factory=dict)
    # checkpoint-aware preemption: epoch counts incarnations (bumped on
    # every preempt-requeue so terminal events from a superseded run are
    # recognizably stale); preempt_flag is the cooperative checkpoint
    # signal threaded runners hand the job fn (a threading.Event — the fn
    # polls it and raises JobPreempted to yield at a checkpoint)
    epoch: int = 0
    preemptions: int = 0
    preempt_flag: Any = dataclasses.field(default=None, repr=False,  # acailint: runtime-only
                                          compare=False)
    # live gang width: set at launch (spec.gang.n_pods) and lowered by an
    # elastic shrink-to-k resize; None for ordinary single-pod jobs. The
    # training stack's gang_resize_hook watches it to re-mesh in place.
    gang_pods: Optional[int] = None
    # fault-tolerance bookkeeping: retries counts FAILED->QUEUED rebirths
    # (bounded by spec.retry.max_retries), failures counts *consecutive*
    # non-transient failures (a transient failure breaks the streak) —
    # the scheduler quarantines at its crash-loop threshold
    retries: int = 0
    failures: int = 0
    # retry-decision latch: raised (under the registry lock, in the same
    # commit as the FAILED transition) when the spec carries a retry
    # policy, lowered once the scheduler decides retry-or-not. Waiters
    # must not treat FAILED as terminal while it is up — the job may be
    # reborn as a new epoch a moment later. In-memory only: never
    # journaled, defaults down on recovery.
    retry_pending: bool = dataclasses.field(default=False, repr=False,  # acailint: runtime-only
                                            compare=False)

    @property
    def queue_key(self) -> tuple[str, str]:
        return (self.spec.project, self.spec.user)


class JobRegistry:
    def __init__(self, metadata=None, journal=None):
        self._jobs: dict[str, Job] = {}  # guarded-by: _lock
        self._ctr = 0  # guarded-by: _lock
        self.metadata = metadata
        # optional write-ahead journal (durable control plane): every
        # state-changing commit records through it while still holding
        # the registry lock, so journal order matches commit order
        self.journal = journal
        # journaling happens inside this lock (order == commit order),
        # but bus publishes, metadata-store writes and runner launches
        # must not — they nest foreign locks/IO under the registry lock
        self._lock = threading.RLock()  # acailint: lock(forbid: publish, metadata, launch)
        if metadata is not None:
            # resume the id counter past persisted jobs so a restarted
            # engine (e.g. a new CLI invocation over the same root) never
            # reuses an earlier job's id and overwrites its metadata
            for aid in metadata.find(kind="job"):
                m = re.fullmatch(r"job-(\d+)", aid)
                if m:
                    self._ctr = max(self._ctr, int(m.group(1)))

    def submit(self, spec: JobSpec) -> Job:
        with self._lock:
            self._ctr += 1
            job = Job(job_id=f"job-{self._ctr}", spec=spec)
            self._jobs[job.job_id] = job
            if self.journal is not None:
                self.journal.job_submitted(job)
        if self.metadata is not None:
            self.metadata.register(job.job_id, kind="job",
                                   creator=spec.user, model=spec.name,
                                   project=spec.project)
        return job

    def get(self, job_id: str) -> Job:
        with self._lock:
            return self._jobs[job_id]

    def all_jobs(self) -> list[Job]:
        with self._lock:
            return list(self._jobs.values())

    def adopt(self, job: Job) -> None:
        """Install a job rebuilt from the durable store (crash recovery):
        no transition checks, no metadata registration — the job is
        already history, not a new submission. The id counter advances
        past it so post-recovery submits never reuse its id. The install
        is journaled like any other durable mutation; recovery wraps the
        rebuild in ``journal.paused()``, so replay never double-records,
        while an adoption outside recovery survives the next crash."""
        with self._lock:
            self._jobs[job.job_id] = job
            m = re.fullmatch(r"job-(\d+)", job.job_id)
            if m:
                self._ctr = max(self._ctr, int(m.group(1)))
            if self.journal is not None:
                self.journal.job_submitted(job)
                self.journal.job_state(job)

    def force_state(self, job_id: str, new: JobState) -> Job:
        """Privileged reassignment: install ``new`` without consulting
        the transition table. Reserved for reattachment paths (e.g. the
        scheduler adopting an already-RUNNING job after recovery) where
        the job's true state is externally known rather than derived by
        an edge. Journaled like any transition so the durable story
        stays complete."""
        with self._lock:
            job = self._jobs[job_id]
            job.state = new
            if new == JobState.RUNNING and job.started_at is None:
                job.started_at = time.time()
            if self.journal is not None:
                self.journal.job_state(job)
            return job

    def set_state(self, job_id: str, new: JobState,
                  error: Optional[str] = None,
                  expect_epoch: Optional[int] = None) -> Optional[Job]:
        """Transition the job; with ``expect_epoch`` the write commits
        only while ``job.epoch`` still matches (returns None otherwise) —
        the check and the write share the registry lock, so a superseded
        worker can never terminal-ize an incarnation that was preempted
        (and epoch-bumped) after its last unlocked epoch read."""
        with self._lock:
            job = self._jobs[job_id]
            if expect_epoch is not None and job.epoch != expect_epoch:
                return None
            check_transition(job.state, new)
            job.state = new
            # raise/lower the retry-decision latch atomically with the
            # transition: a waiter that samples the registry between this
            # commit and the scheduler's retry decision must not resolve
            # a FAILED job that is about to be reborn
            job.retry_pending = (new == JobState.FAILED
                                 and job.spec.retry is not None)
            if new == JobState.RUNNING:
                job.started_at = time.time()
            if new in TERMINAL_STATES:
                job.finished_at = time.time()
                job.error = error
            if self.journal is not None:
                self.journal.job_state(job)
            return job

    def mark_preempted(self, job_id: str) -> Job:
        """Atomically ``RUNNING -> PREEMPTED`` + epoch bump (+ preemption
        count) under the registry lock, so the epoch a concurrent
        worker's ``set_state(expect_epoch=...)`` compares against can
        never be mid-bump."""
        with self._lock:
            job = self._jobs[job_id]
            check_transition(job.state, JobState.PREEMPTED)
            job.state = JobState.PREEMPTED
            job.epoch += 1
            job.preemptions += 1
            if self.journal is not None:
                self.journal.job_preempted(job)
            return job

    def note_failure(self, job_id: str, transient: bool) -> int:
        """Record one failed incarnation under the registry lock and
        return the job's *consecutive non-transient* failure count — the
        crash-loop signal the scheduler quarantines on. A transient
        failure breaks the streak (the job is flaky, not crash-looping).
        """
        with self._lock:
            job = self._jobs[job_id]
            job.failures = 0 if transient else job.failures + 1
            return job.failures

    def mark_retrying(self, job_id: str) -> Job:
        """Atomically rebirth a FAILED job into QUEUED for a retry:
        epoch bump + retry count under the registry lock, mirroring
        ``mark_preempted``. Like crash recovery's requeue this is an
        epoch rebirth, not a transition-table edge — FAILED stays
        terminal in ``_TRANSITIONS``; only this privileged op (driven by
        an explicit ``JobSpec.retry`` budget) may resurrect it. The last
        failure's ``error`` is kept as the job's last-failure reason."""
        with self._lock:
            job = self._jobs[job_id]
            if job.state != JobState.FAILED:
                raise IllegalTransition(
                    f"retry of {job_id} in state {job.state.value}")
            job.state = JobState.QUEUED
            job.retry_pending = False
            job.finished_at = None
            job.epoch += 1
            job.retries += 1
            if self.journal is not None:
                self.journal.job_retried(job)
            return job

    def persist_state(self, job_id: str) -> None:
        """Persist the job's state to the metadata store. The runner's
        finalize does this for jobs it completes; the scheduler calls it
        for terminals that never reach a runner (UPSTREAM_FAILED, queued
        kills, infeasible submits), so cross-process status readers see
        every outcome. Failure reason (first line) and retry count ride
        along so a cross-process ``acai status`` can answer "why"."""
        if self.metadata is not None:
            job = self.get(job_id)
            extra: dict[str, Any] = {}
            if job.error:
                extra["error"] = str(job.error).strip().splitlines()[-1][:200]
            if job.retries:
                extra["retries"] = job.retries
            self.metadata.put(job_id, state=job.state.value, **extra)
