"""Job launcher + in-container agent (ACAI §4.2, §4.2.1).

A copy of ``repro/core/engine/launcher.py``, with its imports in
``repro_torch.core``, and three changes: once CUDA is initialised, the
runner waits for the stream a job ran on before it reads the job's end time
(``jobthread.elapsed``), so a runtime covers the job's device work and not
only its launches; each ``ThreadPoolRunner`` worker runs its jobs on a CUDA stream
of its own, so that wait covers its own job and not the other workers'
queued work; and the default ``workroot`` is ``<TMPDIR>/acai-jobs``, not a
fixed ``/tmp`` path.

The paper provisions a Kubernetes container whose pre-installed agent
downloads code + input file set, runs the user command, uploads the output
file set, and broadcasts progress on the event bus. The ``Runner`` interface
reproduces that protocol; two implementations ship:

  LocalRunner      — executes the job's python callable synchronously in a
                     scratch "container" directory (real measured runtime).
  ThreadPoolRunner — LocalRunner semantics on a bounded worker pool:
                     ``launch`` returns immediately and the agent protocol
                     (download/run/upload/publish) runs on a worker thread;
                     ``pending``/``step`` let the scheduler drain it like
                     the virtual runner.
  VirtualRunner    — completes jobs on a virtual clock using a runtime
                     oracle (duration = spec.duration or oracle(job)); this
                     is what the auto-provisioning experiments schedule
                     thousands of profiling jobs on, and what exercises
                     quota/capacity/straggler logic deterministically. It
                     exposes expected completion times so the scheduler's
                     EASY backfill can compute shadow start times.
"""
from __future__ import annotations

import heapq
import io
import os
import tempfile
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from contextlib import redirect_stdout
from pathlib import Path
from typing import Callable, Optional

import torch

from repro_torch.core.engine.events import (EventBus, TOPIC_CONTAINER_STATUS,
                                            TOPIC_JOB_PROGRESS)
from repro_torch.core.engine.lifecycle import (IllegalTransition, JobPreempted,
                                               JobState, TERMINAL_STATES,
                                               TransientJobError)
from repro_torch.core.engine import jobthread
from repro_torch.core.engine.logparse import parse_log
from repro_torch.core.engine.registry import Job, JobRegistry


# per-segment billing accumulates into job.cost from worker threads — a
# zombie (superseded) worker and the live incarnation's finalize can
# race the read-modify-write and silently drop a segment without this
_billing_lock = threading.Lock()


def _hand_over(result, stream) -> None:
    """Mark the CUDA tensors of a job's result dict (its values, and those
    inside lists, tuples and dicts there) as used by their device's default
    stream (``record_stream``), when the job ran on a worker's ``stream``.
    Such a tensor was allocated from that stream's pool. Unmarked, a caller
    that frees it while its default-stream kernels still read it would hand
    the memory back to the worker stream at once, where a job already
    running on that worker could take it and write over it."""
    if stream is None or not isinstance(result, dict):
        return
    todo = list(result.values())
    while todo:
        v = todo.pop()
        if isinstance(v, torch.Tensor) and v.is_cuda:
            v.record_stream(torch.cuda.default_stream(v.device))
        elif isinstance(v, (list, tuple)):
            todo.extend(v)
        elif isinstance(v, dict):
            todo.extend(v.values())


def _gang_width(job: Job) -> int:
    """The job's current pod count: the live (possibly shrunk) width when
    the scheduler tracks one, else the declared gang width, else 1."""
    width = getattr(job, "gang_pods", None)
    if width:
        return width
    return getattr(job.spec, "n_pods", 1)


def _bill_segment(pricing, job: Job, seconds: float) -> None:
    """Accumulate one segment's cost onto the job, thread-safely. A gang
    bills every pod: n_pods x the per-pod resource cost."""
    if pricing is None:
        return
    cost = pricing.job_cost(job.spec.resources, seconds) * _gang_width(job)
    with _billing_lock:
        job.cost = (job.cost or 0.0) + cost


def resolve_pricing(pricing, job: Job):
    """The pricing that bills ``job``: a plain ``Pricing`` applies to every
    job; a catalog (``{pool_name: Pricing}``, heterogeneous deployments)
    resolves through the pool placement launched the job on."""
    if isinstance(pricing, dict):
        if job.pool and job.pool in pricing:
            return pricing[job.pool]
        if "default" in pricing:
            return pricing["default"]
        return next(iter(pricing.values()), None) if pricing else None
    return pricing


class Runner:
    # True when jobs complete on worker threads (terminal events arrive
    # asynchronously); JobHandle.wait blocks on the bus instead of stepping
    threaded = False

    # optional write-ahead journal (durable control plane): runners that
    # bank checkpoint progress record it here so a crash-recovered
    # relaunch resumes from the checkpoint instead of step 0
    journal = None

    # runner-clock time, or None to fall back to wall time: the virtual
    # runner advances this; schedulers read it for queue-wait accounting,
    # fair-share decay and backfill math
    now: Optional[float] = None

    def launch(self, job: Job) -> None:
        raise NotImplementedError

    # -- optional hooks the capacity scheduler consults -----------------
    def expected_duration(self, job: Job,
                          pool: Optional[str] = None) -> Optional[float]:
        """Best-effort runtime estimate for backfill — on ``pool`` when
        the scheduler is sizing a specific pool's hole; None if unknown.
        Must be a pure read when ``job.spec.duration`` is declared (the
        scheduler may then consult it eagerly at enqueue); estimates that
        draw from an oracle are only requested from inside a dispatch
        scan, and are drawn once per (job, pool)."""
        return job.spec.duration

    def expected_end(self, job_id: str) -> Optional[float]:
        """Expected completion time of a running job; None if unknown.
        The scheduler reads this once, immediately after ``launch``, to
        feed the pool's incrementally-maintained shadow state — the
        estimate must therefore be available synchronously at launch (the
        virtual runner schedules the completion inside ``launch``) and
        stay fixed for the life of the job."""
        return

    # Runners that can deliver a checkpoint signal to a RUNNING job
    # implement ``preempt(job) -> bool`` (True = signal delivered, the
    # job will stop; False = the job is not running here). The scheduler
    # only enables its preemption policy when the launcher has it; the
    # base Runner and the synchronous LocalRunner deliberately do not
    # (a synchronous agent cannot be signalled mid-run).


class LocalRunner(Runner):
    """Synchronous agent: download -> run -> upload -> publish."""

    def __init__(self, registry: JobRegistry, bus: EventBus, *,
                 datalake=None, workroot: Optional[str] = None,
                 pricing=None):
        self.registry = registry
        self.bus = bus
        self.datalake = datalake            # AcaiProject-like facade or None
        # the reference defaults to the fixed "/tmp/acai-jobs"; the port
        # follows TMPDIR, so runs with their own TMPDIR, whose job ids all
        # count from 1, do not meet in one directory
        self.workroot = Path(workroot or os.path.join(tempfile.gettempdir(),
                                                      "acai-jobs"))
        self.pricing = pricing

    def _capture(self, log_buf: io.StringIO):
        """Capture the job fn's stdout into its log buffer."""
        return redirect_stdout(log_buf)

    def _job_stream(self):
        """The CUDA stream a job runs on: None, the caller's current
        stream, for the synchronous runner."""
        return None

    def launch(self, job: Job) -> None:
        bus, reg = self.bus, self.registry
        epoch = job.epoch        # incarnation this launch belongs to
        try:
            reg.set_state(job.job_id, JobState.RUNNING)
        except IllegalTransition:
            # killed between dispatch and worker pickup: publish the
            # terminal status so waiters and dependents still observe it
            reg.persist_state(job.job_id)
            bus.publish(TOPIC_CONTAINER_STATUS,
                        {"job_id": job.job_id, "epoch": epoch,
                         "status": reg.get(job.job_id).state.value})
            return
        bus.publish(TOPIC_CONTAINER_STATUS,
                    {"job_id": job.job_id, "status": "provisioned"})
        workdir = self.workroot / job.job_id
        (workdir / "out").mkdir(parents=True, exist_ok=True)
        log_buf = io.StringIO()
        stream = self._job_stream()
        t0 = time.perf_counter()
        try:
            if job.spec.input_fileset and self.datalake is not None:
                bus.publish(TOPIC_JOB_PROGRESS,
                            {"job_id": job.job_id, "stage": "downloading"})
                self.datalake.filesets.materialize(job.spec.input_fileset,
                                                   workdir)
            bus.publish(TOPIC_JOB_PROGRESS,
                        {"job_id": job.job_id, "stage": "running"})
            with self._capture(log_buf), jobthread.on_stream(stream):
                result = job.spec.fn(workdir, job) if job.spec.fn else None
            _hand_over(result, stream)
            if job.epoch != epoch:
                # superseded while the fn ran (preempted, but it never
                # observed the signal): the live incarnation owns the
                # job's outputs and state — discard this zombie segment
                # without uploading or finalizing, but bill the compute
                # it really consumed (same as the cooperative path)
                _bill_segment(resolve_pricing(self.pricing, job), job,
                              jobthread.elapsed(t0, stream))
                bus.publish(TOPIC_JOB_PROGRESS,
                            {"job_id": job.job_id, "stage": "superseded",
                             "epoch": epoch})
                return
            # stage result/fileset mutations instead of applying them:
            # they commit in _finalize only after the epoch-guarded
            # terminal write succeeds, so a worker superseded *during*
            # the (slow) upload cannot clobber the live incarnation's
            # outputs — its staged delta is simply dropped
            delta = dict(result) if isinstance(result, dict) else {}
            runtime = jobthread.elapsed(t0, stream)
            job.runtime = job.spec.duration if job.spec.duration is not None \
                else runtime
            ref = self._upload_outputs(job, workdir, bus)
            if ref is not None:
                delta["fileset"] = ref
            self._finalize(job, log_buf.getvalue(), JobState.FINISHED,
                           epoch=epoch, outputs=delta)
        except JobPreempted:
            # the checkpoint signal reached the fn. A *real* preemption
            # bumped the job's epoch (and settled/re-queued it — possibly
            # already relaunched as a new RUNNING incarnation): bill the
            # partial segment and hand back with no terminal publish. A
            # spurious JobPreempted (same epoch, still RUNNING: nobody
            # preempted this job) fails like any other exception, or the
            # job would hang non-terminal forever.
            if job.epoch == epoch and \
                    reg.get(job.job_id).state == JobState.RUNNING:
                job.runtime = jobthread.elapsed(t0, stream, quiet=True)
                self._finalize(job, log_buf.getvalue()
                               + "\nJobPreempted without a scheduler "
                               "preemption", JobState.FAILED,
                               error="JobPreempted outside a preemption",
                               epoch=epoch)
                return
            _bill_segment(resolve_pricing(self.pricing, job), job,
                          jobthread.elapsed(t0, stream, quiet=True))
            bus.publish(TOPIC_JOB_PROGRESS,
                        {"job_id": job.job_id, "stage": "preempted",
                         "epoch": epoch})
        except TransientJobError:
            # the job classified its own failure as retryable (lost
            # connection, flaky dependency): FAILED, but stamped transient
            # so a retry_on="transient" policy has a real signal
            job.runtime = jobthread.elapsed(t0, stream, quiet=True)
            self._finalize(job, log_buf.getvalue()
                           + "\n" + traceback.format_exc(), JobState.FAILED,
                           error=traceback.format_exc(), epoch=epoch,
                           transient=True)
        except Exception:  # noqa: BLE001 — user code failure => FAILED
            job.runtime = jobthread.elapsed(t0, stream, quiet=True)
            self._finalize(job, log_buf.getvalue()
                           + "\n" + traceback.format_exc(), JobState.FAILED,
                           error=traceback.format_exc(), epoch=epoch)

    def _upload_outputs(self, job: Job, workdir: Path,
                        bus: EventBus) -> Optional[str]:
        """Upload the job's output fileset; returns its versioned ref
        (committed onto ``job.outputs`` by the caller only once the
        epoch-guarded terminal write lands)."""
        if not (job.spec.output_fileset and self.datalake is not None):
            return None
        bus.publish(TOPIC_JOB_PROGRESS,
                    {"job_id": job.job_id, "stage": "uploading"})
        lake = self.datalake
        outdir = workdir / "out"
        files = [p for p in sorted(outdir.rglob("*")) if p.is_file()]
        specs = []
        if files:
            paths = [f"/{job.spec.output_fileset}/{p.relative_to(outdir)}"
                     for p in files]
            sid = lake.storage.begin_session(paths, creator=job.spec.user)
            for p, path in zip(files, paths):
                lake.storage.session_put(sid, path, p.read_bytes())
            for fv in lake.storage.commit_session(sid):
                specs.append(f"{fv.path}@{fv.version}")
                lake.metadata.register(f"{fv.path}@{fv.version}",
                                       kind="file", creator=job.spec.user)
        fsv = lake.filesets.create(job.spec.output_fileset, specs,
                                   creator=job.spec.user)
        lake.metadata.register(fsv.ref, kind="fileset",
                               creator=job.spec.user)
        src_ref = None
        if job.spec.input_fileset:
            src_ref = lake.filesets.resolve(job.spec.input_fileset).ref
        lake.provenance.add_job_edge(src=src_ref, dst=fsv.ref,
                                     job_id=job.job_id,
                                     creator=job.spec.user)
        return fsv.ref

    def _finalize(self, job: Job, log_text: str, state: JobState,
                  error: Optional[str] = None,
                  epoch: Optional[int] = None,
                  outputs: Optional[dict] = None,
                  transient: bool = False) -> None:
        if epoch is not None and job.epoch != epoch:
            # a superseded incarnation must not write the registry, bill,
            # or publish: the job is live again (re-queued or relaunched)
            # and a FINISHED/FAILED here would terminal-ize it under the
            # new incarnation's feet
            return
        # the job may have been killed while the fn ran (thread workers):
        # keep the registry's terminal state, don't overwrite it
        if self.registry.get(job.job_id).state in TERMINAL_STATES:
            state = self.registry.get(job.job_id).state
        else:
            try:
                # epoch-guarded write: the check above is advisory (the
                # preemption can land between it and here), but the
                # registry re-checks the epoch under its own lock — a
                # zombie can never terminal-ize the live incarnation
                if self.registry.set_state(job.job_id, state, error=error,
                                           expect_epoch=epoch) is None:
                    return              # superseded mid-flight: hands off
            except IllegalTransition:   # killed between check and set
                state = self.registry.get(job.job_id).state
        if epoch is not None and job.epoch != epoch:
            return      # superseded on the IllegalTransition path: the
                        # job re-queued under us — no billing/publish
        if outputs:
            # commit the staged result/fileset delta only now, with the
            # terminal state claimed: a zombie never reaches this line
            job.outputs.update(outputs)
        if job.runtime is not None:
            # accumulate, not overwrite: preempted incarnations already
            # billed their partial segments
            _bill_segment(resolve_pricing(self.pricing, job), job,
                          job.runtime)
        if self.datalake is not None:
            meta = parse_log(log_text)      # intelligent log parser
            if meta:
                self.datalake.metadata.put(job.job_id, **meta)
            self.datalake.metadata.put(job.job_id, runtime=job.runtime,
                                       cost=job.cost, state=state.value)
            # log text goes to the lake, not the metadata store: metadata
            # values are bisect-indexed and rewritten wholesale on every
            # put, so logs there would grow completion cost quadratically
            self.datalake.storage.upload(f"/.logs/{job.job_id}.log",
                                         log_text.encode(),
                                         creator=job.spec.user)
        job.outputs["log"] = log_text
        msg = {"job_id": job.job_id, "status": state.value}
        if transient and state == JobState.FAILED:
            # transient-vs-fatal rides the terminal event: the scheduler's
            # retry policy reads it without re-parsing the traceback
            msg["transient"] = True
        if epoch is not None:
            # stamp the incarnation: the scheduler drops terminal events
            # whose epoch predates the job's current one (a worker that
            # finished after its job was preempted and relaunched must
            # not settle the new incarnation's reservation)
            msg["epoch"] = epoch
        self.bus.publish(TOPIC_CONTAINER_STATUS, msg)


class ThreadPoolRunner(LocalRunner):
    """Concurrent LocalRunner: the same agent protocol (download -> run ->
    upload -> publish), executed on a bounded pool of worker threads so the
    scheduler can keep the cluster full. ``pending``/``step`` mirror the
    virtual runner so ``run_to_completion`` drains either transparently.

    Once CUDA is initialised, each worker thread runs its jobs' fns on a
    CUDA stream of its own (on the device current when the worker first
    needs it), which first waits for the default stream's queued work; a
    job's runtime waits for that stream only, so it excludes the other
    workers' queued device work. Device work a job puts on a side stream of
    its own without joining it back is not waited for. Tensors a job
    returns in its result dict were made on its worker's stream, which the
    runner has waited for before the job's handle resolves, and are marked
    as used by the default stream (``_hand_over``), so the caller may read
    and free them there; a caller that reads them on another stream calls
    ``record_stream`` for it. The other direction is PyTorch's usual rule:
    a job that drops the last reference to a tensor made on another stream
    while its own stream may still read it calls ``record_stream`` first.
    While CUDA is not initialised no stream is made and no CUDA call is
    made, as in the reference."""

    threaded = True

    def __init__(self, registry: JobRegistry, bus: EventBus, *,
                 datalake=None, workroot: Optional[str] = None,
                 pricing=None, max_workers: int = 4):
        super().__init__(registry, bus, datalake=datalake,
                         workroot=workroot, pricing=pricing)
        self.max_workers = max_workers
        self._executor = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="acai-agent")
        self._cv = threading.Condition()
        # job_id -> number of in-flight runs: a preempted job's relaunch
        # can overlap its superseded worker, and a plain set would let
        # the zombie's exit erase the live incarnation from the books
        # (pending() -> 0 while the job still runs)
        self._inflight: dict[str, int] = {}
        self._completions = 0
        self._worker = threading.local()       # each worker's CUDA stream

    def _job_stream(self):
        if not torch.cuda.is_initialized():
            return None
        stream = getattr(self._worker, "stream", None)
        if stream is None:
            stream = self._worker.stream = torch.cuda.Stream()
        return stream

    def _capture(self, log_buf: io.StringIO):
        """Capture this worker thread's stdout only."""
        return jobthread.capture_stdout(log_buf)

    def launch(self, job: Job) -> None:
        # fresh checkpoint signal per incarnation: a relaunched preempted
        # job must not see the previous incarnation's set flag
        job.preempt_flag = threading.Event()
        with self._cv:
            self._inflight[job.job_id] = \
                self._inflight.get(job.job_id, 0) + 1
        self._executor.submit(self._run, job)

    def preempt(self, job: Job) -> bool:
        """Cooperative checkpoint signal: sets the job's ``preempt_flag``.
        The job fn is expected to poll it (e.g. via
        ``train.fault.preemption_hook``) and raise ``JobPreempted`` at
        its next checkpoint; capacity is handed back immediately (the
        same early-release semantics as ``kill`` on a running worker)."""
        with self._cv:
            if job.job_id not in self._inflight:
                return False
        flag = job.preempt_flag
        if flag is None:
            return False
        flag.set()
        return True

    def _run(self, job: Job) -> None:
        try:
            LocalRunner.launch(self, job)
        finally:
            with self._cv:
                left = self._inflight.get(job.job_id, 0) - 1
                if left > 0:
                    self._inflight[job.job_id] = left
                else:
                    self._inflight.pop(job.job_id, None)
                self._completions += 1
                self._cv.notify_all()

    def pending(self) -> int:
        with self._cv:
            return len(self._inflight)

    def step(self, timeout: float = 120.0) -> None:
        """Block until at least one in-flight job completes (or none are
        left) — the drain primitive ``run_to_completion`` loops on."""
        with self._cv:
            seen = self._completions
            self._cv.wait_for(
                lambda: self._completions > seen or not self._inflight,
                timeout)

    def shutdown(self) -> None:
        self._executor.shutdown(wait=True)


class VirtualRunner(Runner):
    """Virtual-clock agent for simulated fleets (profiling experiments).

    The duration is drawn ONCE at launch (stochastic oracles stay
    consistent between the scheduled end and the recorded runtime) and the
    expected completion time is exposed for EASY backfill. KILLED jobs
    publish their terminal ``container_status`` exactly like FINISHED ones,
    so monitors/dashboards observe kills on the virtual clock.

    Checkpoint-aware preemption: ``preempt(job)`` cancels the scheduled
    completion and records the job's checkpointed progress — work done
    this segment rounds *down* to the last multiple of the checkpoint
    interval (``checkpoint_interval`` here, or a per-job
    ``spec.args["checkpoint_interval"]`` override), so the work lost to a
    preemption is bounded by one interval; with no interval configured
    the job restarts from zero (there was never a checkpoint to restore).
    Progress is kept as a *fraction* of the job, so a relaunch on a
    different (faster/slower) pool resumes from the same logical step.
    A preempted launch's stale heap entry is suppressed by sequence
    number — it can neither complete the new incarnation nor advance the
    clock.
    """

    def __init__(self, registry: JobRegistry, bus: EventBus, *,
                 oracle: Optional[Callable[[Job], float]] = None,
                 pricing=None, checkpoint_interval: Optional[float] = None):
        self.registry = registry
        self.bus = bus
        self.oracle = oracle
        self.pricing = pricing
        self.checkpoint_interval = checkpoint_interval
        self.now = 0.0
        self._heap: list[tuple[float, int, str, float]] = []
        self._ends: dict[str, float] = {}
        # job_id -> {pool: duration}: pool-dependent oracles (heterogeneous
        # fleets where a TPU pool runs the same work faster) are re-drawn
        # when placement assigns a pool, while the pre-launch backfill
        # estimate and the launch still share one draw per (job, pool)
        self._dur_cache: dict[str, dict] = {}
        self._seq = 0
        # preemption bookkeeping: the live heap-entry seq per running job
        # (mismatched pops are stale), this segment's launch time and full
        # duration on its pool, and checkpointed progress as a fraction
        self._live_seq: dict[str, int] = {}
        self._launch_t: dict[str, float] = {}
        self._full_dur: dict[str, float] = {}
        self._done_frac: dict[str, float] = {}
        # advance-warning checkpoints: job_id -> work-seconds explicitly
        # banked by request_checkpoint (a reclaim grace window), honored
        # by the next preempt even when off the interval grid
        self._ckpt_mark: dict[str, float] = {}
        self.preempt_stats = {"preemptions": 0, "lost_work_s": 0.0,
                              "max_lost_s": 0.0, "resumed_s": 0.0}

    _UNSET = object()

    def _draw_duration(self, job: Job, pool=_UNSET) -> float:
        """One oracle draw per (job, pool), shared between the backfill
        estimate and the actual launch — stochastic oracles stay
        consistent and the RNG stream does not depend on how often the
        scheduler peeks. ``pool`` lets the scheduler ask "how long on
        THIS pool" before placement assigns one; the oracle sees it as
        ``job.pool`` for the duration of the draw."""
        if job.spec.duration is not None:
            return job.spec.duration
        key = job.pool if pool is self._UNSET else pool
        per_pool = self._dur_cache.setdefault(job.job_id, {})
        if key not in per_pool:
            prev, job.pool = job.pool, key
            try:
                per_pool[key] = self.oracle(job)
            finally:
                job.pool = prev
        return per_pool[key]

    def launch(self, job: Job) -> None:
        self.registry.set_state(job.job_id, JobState.RUNNING)
        full = self._draw_duration(job)
        done = self._done_frac.get(job.job_id, 0.0)
        # resume from the last checkpoint: only the un-checkpointed
        # remainder of the job runs this segment
        dur = max(full * (1.0 - done), 0.0)
        if done:
            self.preempt_stats["resumed_s"] += full * done
        self._seq += 1
        self._live_seq[job.job_id] = self._seq
        self._launch_t[job.job_id] = self.now
        self._full_dur[job.job_id] = full
        self._ends[job.job_id] = self.now + dur
        heapq.heappush(self._heap, (self.now + dur, self._seq, job.job_id,
                                    dur))

    def step(self) -> Optional[str]:
        """Advance to the next completion; returns the finished job id."""
        while self._heap:
            t, seq, job_id, dur = heapq.heappop(self._heap)
            if self._live_seq.get(job_id) != seq:
                continue    # stale entry from a preempted incarnation:
                            # must not complete the job or move the clock
            self.now = max(self.now, t)
            self._ends.pop(job_id, None)
            self._dur_cache.pop(job_id, None)
            self._live_seq.pop(job_id, None)
            self._launch_t.pop(job_id, None)
            self._full_dur.pop(job_id, None)
            self._done_frac.pop(job_id, None)
            self._ckpt_mark.pop(job_id, None)
            job = self.registry.get(job_id)
            # the seq check already filtered stale incarnations, but the
            # published events still carry the epoch stamp: handlers
            # (and replayed histories) must be able to judge staleness
            # without knowing this runner's private seq bookkeeping
            if job.state == JobState.KILLED:
                self.bus.publish(TOPIC_CONTAINER_STATUS,
                                 {"job_id": job_id, "status": "KILLED",
                                  "epoch": job.epoch})
                return job_id
            job.runtime = dur
            pricing = resolve_pricing(self.pricing, job)
            if pricing is not None:
                # accumulate: preempted segments already billed theirs
                job.cost = (job.cost or 0.0) + \
                    pricing.job_cost(job.spec.resources, dur) * \
                    _gang_width(job)
            self.registry.set_state(job_id, JobState.FINISHED,
                                    expect_epoch=job.epoch)
            self.bus.publish(TOPIC_CONTAINER_STATUS,
                             {"job_id": job_id, "status": "FINISHED",
                              "epoch": job.epoch})
            return job_id
        return None

    def pending(self) -> int:
        return len(self._heap)

    # -- checkpoint-aware preemption ------------------------------------
    def preempt(self, job: Job) -> bool:
        """Deliver the checkpoint signal: cancel the scheduled completion
        and bank the segment's checkpointed progress. Returns False when
        the job is not running here (already completed or never launched).
        """
        jid = job.job_id
        if jid not in self._ends or jid not in self._live_seq:
            return False
        full = self._full_dur.get(jid, 0.0)
        elapsed = max(0.0, self.now - self._launch_t.get(jid, self.now))
        done0 = self._done_frac.get(jid, 0.0)
        interval = self.checkpoint_interval
        if isinstance(job.spec.args, dict):
            interval = job.spec.args.get("checkpoint_interval", interval)
        progressed = done0 * full + elapsed     # work done, in this
        if interval and interval > 0:           # pool's runtime seconds
            saved = min(int(progressed / interval + 1e-9) * interval,
                        progressed)
        else:
            saved = 0.0     # never checkpointed: restart from step 0
        # an advance-warning checkpoint (request_checkpoint) banked exact
        # progress off the interval grid: honor whichever saved more
        mark = self._ckpt_mark.pop(jid, None)
        if mark is not None:
            saved = max(saved, min(mark, progressed))
        lost = progressed - saved
        self.preempt_stats["preemptions"] += 1
        self.preempt_stats["lost_work_s"] += lost
        self.preempt_stats["max_lost_s"] = max(
            self.preempt_stats["max_lost_s"], lost)
        self._done_frac[jid] = saved / full if full > 0 else 0.0
        if self.journal is not None:
            self.journal.job_progress(jid, self._done_frac[jid])
        pricing = resolve_pricing(self.pricing, job)
        if pricing is not None:
            job.cost = (job.cost or 0.0) + \
                pricing.job_cost(job.spec.resources, elapsed) * \
                _gang_width(job)
        # drop the live entry; the heap row becomes a stale tombstone
        # (suppressed by seq in step/next_completion)
        self._ends.pop(jid, None)
        self._live_seq.pop(jid, None)
        self._launch_t.pop(jid, None)
        self._full_dur.pop(jid, None)
        return True

    def request_checkpoint(self, job: Job) -> bool:
        """Advance warning (a spot reclamation's grace window): bank the
        job's *exact* current progress as a checkpoint, so the forced
        preempt that lands moments later loses (near) zero work instead
        of up to one checkpoint interval. Returns False when the job is
        not running here."""
        jid = job.job_id
        if jid not in self._ends or jid not in self._live_seq:
            return False
        full = self._full_dur.get(jid, 0.0)
        elapsed = max(0.0, self.now - self._launch_t.get(jid, self.now))
        progressed = self._done_frac.get(jid, 0.0) * full + elapsed
        prev = self._ckpt_mark.get(jid)
        self._ckpt_mark[jid] = max(prev or 0.0, progressed)
        return True

    # -- fault tolerance ------------------------------------------------
    def fail_running(self, job: Job, error: str = "injected fault", *,
                     transient: bool = False) -> bool:
        """Fail a RUNNING job on the virtual clock — the fault injector's
        node-kill / flaky-job path, and the scheduler's per-incarnation
        timeout. Checkpointed progress banks exactly like a preemption
        (a retried incarnation resumes from the last checkpoint), the
        elapsed segment bills, and the terminal event carries the
        transient/fatal classification plus the incarnation's epoch.
        Returns False when the job is not running here."""
        jid = job.job_id
        if jid not in self._ends or jid not in self._live_seq:
            return False
        epoch = job.epoch
        full = self._full_dur.get(jid, 0.0)
        elapsed = max(0.0, self.now - self._launch_t.get(jid, self.now))
        done0 = self._done_frac.get(jid, 0.0)
        interval = self.checkpoint_interval
        if isinstance(job.spec.args, dict):
            interval = job.spec.args.get("checkpoint_interval", interval)
        progressed = done0 * full + elapsed
        if interval and interval > 0:
            saved = min(int(progressed / interval + 1e-9) * interval,
                        progressed)
        else:
            saved = 0.0     # never checkpointed: a retry restarts at 0
        mark = self._ckpt_mark.pop(jid, None)
        if mark is not None:
            saved = max(saved, min(mark, progressed))
        self._done_frac[jid] = saved / full if full > 0 else 0.0
        if self.journal is not None:
            self.journal.job_progress(jid, self._done_frac[jid])
        pricing = resolve_pricing(self.pricing, job)
        if pricing is not None:
            job.cost = (job.cost or 0.0) + \
                pricing.job_cost(job.spec.resources, elapsed) * \
                _gang_width(job)
        # drop the live entry; the heap row becomes a stale tombstone
        self._ends.pop(jid, None)
        self._live_seq.pop(jid, None)
        self._launch_t.pop(jid, None)
        self._full_dur.pop(jid, None)
        if self.registry.set_state(jid, JobState.FAILED, error=error,
                                   expect_epoch=epoch) is None:
            return False
        job.runtime = elapsed
        msg = {"job_id": jid, "status": "FAILED", "epoch": epoch,
               "error": error}
        if transient:
            msg["transient"] = True
        self.bus.publish(TOPIC_CONTAINER_STATUS, msg)
        return True

    def slow_running(self, job: Job, factor: float) -> Optional[float]:
        """Straggler injection: stretch the *remaining* work of a running
        job by ``factor`` (progress already made keeps its original
        pace). Reschedules the completion and returns the new expected
        end — None when the job is not running here."""
        jid = job.job_id
        if jid not in self._ends or jid not in self._live_seq \
                or factor <= 0:
            return None
        full = self._full_dur.get(jid, 0.0)
        elapsed = max(0.0, self.now - self._launch_t.get(jid, self.now))
        done = self._done_frac.get(jid, 0.0)
        if full > 0:
            done = min(1.0, done + elapsed / full)
        pricing = resolve_pricing(self.pricing, job)
        if pricing is not None and elapsed > 0:
            job.cost = (job.cost or 0.0) + \
                pricing.job_cost(job.spec.resources, elapsed) * \
                _gang_width(job)
        new_full = full * factor if full > 0 else 0.0
        rem = max(new_full * (1.0 - done), 0.0)
        self._done_frac[jid] = done
        self._launch_t[jid] = self.now
        self._full_dur[jid] = new_full
        if job.spec.duration is None:
            # a later preempt/retry of this segment resumes against the
            # slowed duration, not a fresh full-speed draw
            self._dur_cache.setdefault(jid, {})[job.pool] = new_full
        self._seq += 1
        self._live_seq[jid] = self._seq
        self._ends[jid] = self.now + rem
        heapq.heappush(self._heap, (self.now + rem, self._seq, jid, rem))
        return self._ends[jid]

    # -- elastic gang resize --------------------------------------------
    def resize_gang(self, job: Job, k: int) -> Optional[float]:
        """Shrink a running gang to ``k`` pods in place (no requeue): the
        segment so far bills at the old width, and the *remaining* work
        re-paces at ``old/k`` x slower — a work-conserving data-parallel
        model. Reschedules the completion and returns the new expected
        end (None when the job is not running here)."""
        jid = job.job_id
        if jid not in self._ends or jid not in self._live_seq:
            return None
        old = _gang_width(job)
        if k < 1 or k == old:
            return self._ends.get(jid)
        full = self._full_dur.get(jid, 0.0)
        elapsed = max(0.0, self.now - self._launch_t.get(jid, self.now))
        done = self._done_frac.get(jid, 0.0)
        if full > 0:
            done = min(1.0, done + elapsed / full)
        pricing = resolve_pricing(self.pricing, job)
        if pricing is not None and elapsed > 0:
            job.cost = (job.cost or 0.0) + \
                pricing.job_cost(job.spec.resources, elapsed) * old
        # remaining logical work runs on k of old pods: the full-job
        # duration at the new width stretches by old/k
        new_full = full * (old / k) if full > 0 else 0.0
        rem = max(new_full * (1.0 - done), 0.0)
        job.gang_pods = k
        self._done_frac[jid] = done
        self._launch_t[jid] = self.now
        self._full_dur[jid] = new_full
        if job.spec.duration is None:
            # future relaunches (a later preemption) must resume against
            # the re-paced duration, not a fresh original-width draw
            self._dur_cache.setdefault(jid, {})[job.pool] = new_full
        self._seq += 1
        self._live_seq[jid] = self._seq
        self._ends[jid] = self.now + rem
        heapq.heappush(self._heap, (self.now + rem, self._seq, jid, rem))
        return self._ends[jid]

    # -- durable recovery hooks -----------------------------------------
    def restore_progress(self, job_id: str, done_frac: float) -> None:
        """Seed a recovered job's checkpointed fraction before its
        relaunch (recovery's counterpart of a live preemption's bank)."""
        if done_frac > 0.0:
            self._done_frac[job_id] = min(1.0, float(done_frac))

    def checkpoint_progress(self) -> dict[str, float]:
        """Banked progress fractions by job id — snapshotted so progress
        survives even after journal compaction discards the records."""
        return dict(self._done_frac)

    def forget(self, job_id: str) -> None:
        """Drop restore/duration state for a job that went terminal with
        no live run here (killed while preempted-queued): nothing will
        ever pop its entries off the completion heap, so a long-lived
        engine would otherwise leak its checkpoint progress and draws.
        A job with a live heap entry keeps everything — its own pop does
        this cleanup (and must still publish the KILLED event)."""
        if job_id in self._live_seq:
            return
        self._done_frac.pop(job_id, None)
        self._dur_cache.pop(job_id, None)
        self._launch_t.pop(job_id, None)
        self._full_dur.pop(job_id, None)
        self._ends.pop(job_id, None)
        self._ckpt_mark.pop(job_id, None)

    # -- open-loop arrival processes ------------------------------------
    def next_completion(self) -> Optional[float]:
        """When the next running job will complete (None if none are)."""
        heap = self._heap
        while heap and self._live_seq.get(heap[0][2]) != heap[0][1]:
            heapq.heappop(heap)     # prune stale preempted entries
        return heap[0][0] if heap else None

    def advance_to(self, t: float) -> None:
        """Advance the idle clock to ``t`` (a future arrival instant);
        never rewinds, never skips scheduled completions — drain those
        with ``step()`` first."""
        self.now = max(self.now, t)

    # -- capacity-scheduler hooks ---------------------------------------
    def expected_duration(self, job: Job,
                          pool: Optional[str] = None) -> Optional[float]:
        if job.spec.duration is None and self.oracle is None:
            return None
        full = self._draw_duration(job) if pool is None \
            else self._draw_duration(job, pool)
        # a preempted job resumes from its checkpoint: size backfill (and
        # relaunch) at the remaining work, not the full duration
        done = self._done_frac.get(job.job_id, 0.0)
        return full * (1.0 - done) if done else full

    def expected_end(self, job_id: str) -> Optional[float]:
        return self._ends.get(job_id)
