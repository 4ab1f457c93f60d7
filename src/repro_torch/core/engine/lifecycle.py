"""Job life-cycle state machine (ACAI Fig. 3, extended with dataflow
and checkpoint-aware preemption).

A copy of ``repro/core/engine/lifecycle.py``, with its imports
in ``repro_torch.core``.

SUBMITTED -> QUEUED -> LAUNCHING -> RUNNING -> {FINISHED, FAILED}
KILLED is reachable from any non-terminal state. UPSTREAM_FAILED is the
terminal outcome of a job that never launched because a declared
dependency (``JobSpec.depends_on``) ended FAILED/KILLED/UPSTREAM_FAILED —
only jobs that have not yet launched can cascade, so it is reachable from
SUBMITTED and QUEUED alone.

PREEMPTED is the one *non-terminal* exit from RUNNING: the scheduler
revoked the job's reservation (priority starvation, a spot reclamation,
or a pool shrink), the runner delivered a checkpoint signal, and the job
re-enters QUEUED for a fresh launch that resumes from its last
checkpoint. This relaxes the original submit-once invariant: the
(input fileset, job, output fileset) triplet is still immutable and the
job id never changes, but a job may now be *scheduled* more than once —
each requeue bumps ``Job.epoch`` so terminal events from a superseded
incarnation are recognizably stale.

Retry rides the same epoch machinery: a FAILED incarnation whose
``JobSpec.retry`` budget allows it is *reborn* into QUEUED by
``JobRegistry.mark_retrying`` — like crash recovery's requeue, a rebirth
is an epoch bump plus direct reassignment, not an edge in the transition
table, so the table itself stays closed (every edge out of a terminal
state lands in a terminal state; FAILED -> QUARANTINED is the only such
edge, refining a crash-looping job's terminal outcome).

QUARANTINED is the crash-loop terminal: K consecutive non-transient
failures and the scheduler stops burning retry budget on the job.
"""
from __future__ import annotations

import enum


class JobState(str, enum.Enum):
    SUBMITTED = "SUBMITTED"
    QUEUED = "QUEUED"
    LAUNCHING = "LAUNCHING"
    RUNNING = "RUNNING"
    PREEMPTED = "PREEMPTED"
    FINISHED = "FINISHED"
    FAILED = "FAILED"
    KILLED = "KILLED"
    UPSTREAM_FAILED = "UPSTREAM_FAILED"
    QUARANTINED = "QUARANTINED"


_TRANSITIONS = {
    JobState.SUBMITTED: {JobState.QUEUED, JobState.KILLED,
                         JobState.UPSTREAM_FAILED},
    JobState.QUEUED: {JobState.LAUNCHING, JobState.KILLED,
                      JobState.UPSTREAM_FAILED},
    JobState.LAUNCHING: {JobState.RUNNING, JobState.FAILED, JobState.KILLED},
    JobState.RUNNING: {JobState.FINISHED, JobState.FAILED, JobState.KILLED,
                       JobState.PREEMPTED},
    JobState.PREEMPTED: {JobState.QUEUED, JobState.KILLED},
    JobState.FINISHED: set(),
    # terminal refinement: a crash-looping FAILED job may be re-labelled
    # QUARANTINED (still terminal) — the one edge out of a terminal state
    JobState.FAILED: {JobState.QUARANTINED},
    JobState.KILLED: set(),
    JobState.UPSTREAM_FAILED: set(),
    JobState.QUARANTINED: set(),
}

ACTIVE_STATES = {JobState.LAUNCHING, JobState.RUNNING}
TERMINAL_STATES = {JobState.FINISHED, JobState.FAILED, JobState.KILLED,
                   JobState.UPSTREAM_FAILED, JobState.QUARANTINED}
# hoisted for event-path dispatch: publishers put the state *value* on the
# bus, and handlers must not rebuild this set per event
TERMINAL_STATUS_VALUES = frozenset(s.value for s in TERMINAL_STATES)


class IllegalTransition(RuntimeError):
    pass


class JobPreempted(RuntimeError):
    """The scheduler's checkpoint signal reached the job: save state and
    stop. Raised by cooperative job functions (see ``train/fault.py``,
    which re-exports it for ``TrainSupervisor``); the preemption-capable
    runners treat it as a hand-back, not a failure."""


class TransientJobError(RuntimeError):
    """A failure the job itself believes is retryable: a lost connection,
    a flaky dependency, a revoked spot node. Job functions raise it (or a
    subclass) instead of a bare exception to tell the runner the failure
    is *transient*; runners stamp the terminal event accordingly and a
    ``RetryPolicy(retry_on="transient")`` requeues the job where an
    arbitrary exception would make it terminally FAILED. Re-exported from
    ``train/fault.py`` alongside ``JobPreempted`` (it lives here so the
    engine can classify failures without importing the train stack).
    """


def check_transition(old: JobState, new: JobState) -> None:
    if new not in _TRANSITIONS[old]:
        raise IllegalTransition(f"{old.value} -> {new.value}")
