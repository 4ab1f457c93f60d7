"""The two job-control exceptions of ``repro/core/engine/lifecycle.py``
that training raises (the job state machine is not copied yet)."""
from __future__ import annotations


class JobPreempted(RuntimeError):
    """The scheduler's checkpoint signal reached the job: save state and
    stop. Raised by cooperative job functions (see ``train/fault.py``,
    which re-exports it for ``TrainSupervisor``); the preemption-capable
    runners treat it as a hand-back, not a failure."""


class TransientJobError(RuntimeError):
    """A failure the job itself believes is retryable: a lost connection,
    a flaky dependency, a revoked spot node. Job functions raise it (or a
    subclass) instead of a bare exception to tell the runner the failure
    is *transient*, so a retry policy may requeue the job where an
    arbitrary exception would make it terminally FAILED."""
