"""Fault tolerance: checkpoint/restart supervision + straggler watchdog (the
port of ``repro/train/fault.py``).

``TrainSupervisor`` wraps a step function with (a) periodic checkpointing
through the data lake, (b) automatic restore-and-continue on failures
(injectable for tests; on a real pod this is the coordinator restart path),
and (c) a step-time watchdog implementing the paper's straggler policy at
training-step granularity (a step slower than ``straggler_factor`` x the
running median is flagged and recorded).

Scheduler preemption ties in through ``preemption_hook(job)``, which turns
the runner's cooperative ``Job.preempt_flag`` into the ``JobPreempted``
the supervisor handles; ``gang_resize_hook`` does the same for a gang that
lost pods. Control flow and report are the reference's, its restart with
no checkpoint included (ROADMAP C). One difference: CUDA runs
asynchronously, so when the state lives on a CUDA device ``run`` waits for
the step's device work before it reads the end time, and the watchdog
times the step, not its launches.

On a mesh every rank runs the supervisor with the same step function,
hooks and schedule, so a failure injected for a step fires on every rank
at that step and every rank restores; ``CheckpointManager.save`` and
``restore`` are collective over DTensor state (rank 0 writes), so a
restart resumes on the template's mesh.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Optional

import torch

from repro_torch.core.engine.lifecycle import (  # noqa: F401 (re-exports)
    JobPreempted, TransientJobError)
from repro_torch.train.checkpoints import CheckpointManager


def preemption_hook(job) -> Callable[[int], None]:
    """A ``TrainSupervisor.run(failure_hook=...)`` adapter for the
    engine's cooperative checkpoint signal: raises ``JobPreempted`` at
    the next step boundary once the scheduler preempts ``job``. The
    preemption-capable runners treat the raise as a hand-back (the job
    re-queues and resumes from its last checkpoint), not a failure.

    Create the hook at the *start* of each incarnation (inside the job
    fn): it captures the incarnation's epoch, so a worker superseded by
    a relaunch still observes its preemption even though the relaunch
    installed a fresh (unset) ``preempt_flag`` on the shared Job —
    polling the flag alone would race that replacement and miss the
    signal."""
    epoch0 = getattr(job, "epoch", 0)

    def hook(step: int) -> None:
        flag = getattr(job, "preempt_flag", None)
        if getattr(job, "epoch", 0) != epoch0 or \
                (flag is not None and flag.is_set()):
            exc = JobPreempted(
                f"{job.job_id} preempted at step {step}")
            # external (scheduler-driven) preemptions must propagate out
            # of the supervisor — the process hands capacity back and the
            # *relaunch* restores; restarting in-process would keep the
            # revoked reservation busy
            exc.external = True
            raise exc
    return hook


def gang_resize_hook(job) -> Callable[[int], None]:
    """A ``failure_hook`` adapter for elastic gang shrink-to-k.

    When the scheduler shrinks a resizable gang (lowers ``job.gang_pods``
    without preempting), the training process keeps its reservation — it
    just lost pods. The reaction is an *in-process* restart: raise a
    non-external ``JobPreempted`` so ``TrainSupervisor.run`` restores the
    latest checkpoint and continues, rather than handing the surviving
    capacity back.

    The hook tracks the last width it acted on, so each shrink fires
    exactly once; compose with :func:`preemption_hook` when the job also
    needs the hand-back path::

        pre, res = preemption_hook(job), gang_resize_hook(job)
        def hook(step):
            pre(step); res(step)
    """
    state = {"w": getattr(job, "gang_pods", None)}

    def hook(step: int) -> None:
        w = getattr(job, "gang_pods", None)
        if w is not None and state["w"] is not None and w < state["w"]:
            state["w"] = w
            raise JobPreempted(
                f"{job.job_id} gang resized to {w} pods at step {step}")
        state["w"] = w
    return hook


@dataclasses.dataclass
class SupervisorReport:
    steps_run: int = 0
    restarts: int = 0
    checkpoints: int = 0
    straggler_steps: list = dataclasses.field(default_factory=list)
    final_step: int = 0


def _wait_for_device(tree) -> None:
    """Wait for the device work that produced ``tree`` (its first leaf's
    device) when that device is a CUDA device."""
    while isinstance(tree, dict) and tree:
        tree = next(iter(tree.values()))
    if isinstance(tree, torch.Tensor) and tree.is_cuda:
        torch.cuda.synchronize(tree.device)


class TrainSupervisor:
    def __init__(self, ckpt: CheckpointManager, *, save_every: int = 10,
                 straggler_factor: float = 3.0, max_restarts: int = 10):
        self.ckpt = ckpt
        self.save_every = save_every
        self.straggler_factor = straggler_factor
        self.max_restarts = max_restarts

    def run(self, step_fn: Callable, state: dict, n_steps: int,
            batch_fn: Callable[[int], dict],
            failure_hook: Optional[Callable[[int], None]] = None,
            time_fn: Callable[[], float] = time.perf_counter,
            ) -> tuple[dict, SupervisorReport]:
        """state: {"params":..., "opt":..., "step": int}."""
        report = SupervisorReport()
        step_times: list[float] = []
        step = state["step"]
        while step < n_steps:
            try:
                if failure_hook is not None:
                    failure_hook(step)       # may raise JobPreempted
                t0 = time_fn()
                params, opt, metrics = step_fn(state["params"],
                                               state["opt"], batch_fn(step))
                _wait_for_device(params)
                dt = time_fn() - t0
                state = {"params": params, "opt": opt, "step": step + 1}
                report.steps_run += 1
                if len(step_times) >= 3:
                    med = statistics.median(step_times)
                    if dt > self.straggler_factor * med:
                        report.straggler_steps.append(step)
                step_times.append(dt)
                step += 1
                if step % self.save_every == 0 or step == n_steps:
                    self.ckpt.save(step, state["params"], state["opt"],
                                   extra={"loss": float(metrics["loss"])})
                    report.checkpoints += 1
            except JobPreempted as e:
                if getattr(e, "external", False):
                    raise   # scheduler preemption: hand back the slot;
                            # the relaunch restores from the checkpoint
                report.restarts += 1
                if report.restarts > self.max_restarts:
                    raise
                restored, ck_step = self._restore_or_initial(state)
                state = restored
                step = ck_step
        report.final_step = step
        return state, report

    def _restore_or_initial(self, template_state):
        last = self.ckpt.latest_step()
        if last is None:
            # the reference's quirk, kept: the live (already trained)
            # state goes on at step 0 (ROADMAP C)
            return {"params": template_state["params"],
                    "opt": template_state["opt"], "step": 0}, 0
        st, step = self.ckpt.restore({"params": template_state["params"],
                                      "opt": template_state["opt"]})
        return {"params": st["params"], "opt": st["opt"], "step": step}, step
