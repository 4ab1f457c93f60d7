"""Job futures: the handle half of the pipeline SDK.

A copy of ``repro/core/engine/handle.py``, with its imports in
``repro_torch.core``, and one fix: on the thread runner a FINISHED or
FAILED job resolves once its worker has committed its outputs, log and
metadata, not as soon as the registry shows the state (ROADMAP C).

``AcaiEngine.submit`` (and ``AcaiPlatform.submit_job``) return a
``JobHandle`` — a future over one job's lifecycle. Synchronisation is
event-driven, not polled: terminal ``container_status`` events on the
EventBus wake waiters through ``JobMonitor.wait_terminal``. Runners that
only make progress when stepped (the virtual clock, and the thread pool's
drain protocol) are driven from inside ``wait`` so a bare
``handle.result()`` is always enough to resolve a job — no ``run_all()``
required.

NSML-style session handles (PAPERS.md) are the model: the handle is the
*only* object a user needs to keep after submit.
"""
from __future__ import annotations

import time
from typing import Any, Optional

from repro_torch.core.engine.lifecycle import TERMINAL_STATES, JobState
from repro_torch.core.engine.registry import Job, JobSpec


# terminal states a worker reaches in its own finalize (a kill, a cascade
# or a quarantine is published by the scheduler)
_WORKER_OUTCOMES = (JobState.FINISHED, JobState.FAILED)


class JobFailedError(RuntimeError):
    """``result()`` on a job that ended FAILED or KILLED."""

    def __init__(self, job: Job):
        self.job_id = job.job_id
        self.state = job.state
        super().__init__(f"{job.job_id} ({job.spec.name}) ended "
                         f"{job.state.value}: {job.error or 'no error'}")


class UpstreamFailedError(JobFailedError):
    """``result()`` on a job cascade-cancelled by a failed dependency."""


class JobHandle:
    """Future over one submitted job.

    Cheap and immutable: holds only the job id and the engine assembly
    (registry / scheduler / launcher / monitor); all state reads go to the
    registry, all blocking goes through the EventBus.
    """

    def __init__(self, job: Job, engine):
        self.job_id: str = job.job_id
        self._engine = engine

    # -- introspection ---------------------------------------------------
    @property
    def job(self) -> Job:
        return self._engine.registry.get(self.job_id)

    @property
    def spec(self) -> JobSpec:
        return self.job.spec

    def status(self) -> JobState:
        return self.job.state

    def done(self) -> bool:
        # a FAILED job whose retry decision is still pending is not done:
        # the scheduler may rebirth it as a new epoch a moment later
        return (self.job.state in TERMINAL_STATES
                and not self.job.retry_pending)

    # -- blocking --------------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> JobState:
        """Block until the job is terminal; returns the terminal state.

        Raises TimeoutError if ``timeout`` seconds elapse first, and
        RuntimeError if the job can provably never finish (nothing running,
        nothing to step — e.g. waiting on a handle whose engine was never
        drained and has no runnable work).
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        launcher = self._engine.launcher
        threaded = getattr(launcher, "threaded", False)
        while True:
            state = self.status()
            if state in TERMINAL_STATES and not self.job.retry_pending \
                    and self._committed(state, threaded):
                return state
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"{self.job_id} still {state.value} after "
                        f"{timeout}s")
            if threaded and state in _WORKER_OUTCOMES:
                # terminal in the registry, outputs not committed yet
                self._engine.monitor.wait_published(
                    self.job_id, self.job.epoch, remaining)
            elif threaded:
                # workers publish terminal events; block on the bus
                self._engine.monitor.wait_terminal(self.job_id, remaining)
            elif callable(getattr(launcher, "step", None)) \
                    and launcher.pending() > 0:
                launcher.step()     # drive the virtual clock forward
            else:
                raise RuntimeError(
                    f"{self.job_id} is {state.value} but the engine has "
                    f"no runnable work to make progress on")

    def _committed(self, state: JobState, threaded: bool) -> bool:
        """The port's change: a FINISHED or FAILED job on worker threads
        is done once its worker has published the terminal event, which
        it does after committing the outputs, log, bill and metadata
        (the registry shows the state first; ``JobMonitor.published``)."""
        return not (threaded and state in _WORKER_OUTCOMES) or \
            self._engine.monitor.published(self.job_id, self.job.epoch)

    def result(self, timeout: Optional[float] = None) -> dict[str, Any]:
        """Wait, then return the job's outputs; raises on non-FINISHED."""
        state = self.wait(timeout)
        job = self.job
        if state == JobState.FINISHED:
            return dict(job.outputs)
        if state == JobState.UPSTREAM_FAILED:
            raise UpstreamFailedError(job)
        raise JobFailedError(job)

    def outputs(self, timeout: Optional[float] = None) -> dict[str, Any]:
        """Wait, then return the outputs dict regardless of outcome
        (log text, fileset ref if any, user-returned values)."""
        self.wait(timeout)
        return dict(self.job.outputs)

    def logs(self) -> str:
        """Log text captured so far (complete once the job is terminal)."""
        return self.job.outputs.get("log", "")

    def cancel(self) -> JobState:
        """Kill the job (queued, held-on-dependencies, or running); held
        dependents cascade to UPSTREAM_FAILED. Returns the new state."""
        self._engine.scheduler.kill(self.job_id)
        return self.status()

    def __repr__(self) -> str:
        return (f"JobHandle({self.job_id}, {self.spec.name!r}, "
                f"{self.status().value})")


def wait_all(handles: list[JobHandle],
             timeout: Optional[float] = None) -> list[JobState]:
    """Resolve every handle; returns terminal states in handle order."""
    deadline = None if timeout is None else time.monotonic() + timeout
    states = []
    for h in handles:
        remaining = None if deadline is None \
            else max(0.0, deadline - time.monotonic())
        states.append(h.wait(remaining))
    return states
