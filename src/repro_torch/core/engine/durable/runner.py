"""Process-boundary runner: jobs run in a detached worker process.

``SubprocessRunner`` speaks the engine's standard ``launch`` /
``pending()`` / ``step()`` drain protocol, but the jobs themselves
execute in a separate worker process (``durable.worker``) connected over
a Unix-domain socket. The worker is spawned in its own session, so it
**survives an engine crash**: after a restart, :func:`recovery.recover`
calls :meth:`adopt`, which reconnects, replays the worker's buffered
results (completed while the engine was down — applied once, never
re-run) and re-attaches still-running jobs at their original epoch.

Job functions must be importable ``module:qualname`` callables — a
closure cannot cross the process boundary, and a launch without an
importable fn FAILs loudly instead of pretending to run.

Terminal application is epoch-guarded end to end: the worker stamps
every result with the epoch it was launched under, and ``_apply`` writes
through ``registry.set_state(expect_epoch=...)`` — a result from a
superseded incarnation (preempted/re-queued while the worker ran) is
dropped, never double-settled.

A copy of ``repro/core/engine/durable/runner.py``, with its imports in
``repro_torch.core``, and these changes: the worker it spawns is the
port's (``python -m repro_torch.core.engine.durable.worker``, with the
port's ``src/`` first on its ``PYTHONPATH``); ``apply_result`` parses a
job's log for ``[[acai:key=value]]`` metrics into the metadata store, as
the in-process runners do (``launcher.LocalRunner._finalize``), where the
reference's never does, so ``metadata.find_min`` finds no job run behind
it (ROADMAP C); and the default ``workdir`` is ``<TMPDIR>/acai-jobs``, not
a fixed ``/tmp`` path, as the port's other runners'.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

from repro_torch.core.engine.durable.codec import encode_fn, json_safe
from repro_torch.core.engine.events import EventBus, TOPIC_CONTAINER_STATUS
from repro_torch.core.engine.launcher import (Runner, _bill_segment,
                                              resolve_pricing)
from repro_torch.core.engine.lifecycle import (TERMINAL_STATES,
                                               IllegalTransition, JobState)
from repro_torch.core.engine.logparse import parse_log
from repro_torch.core.engine.registry import Job, JobRegistry


class SubprocessRunner(Runner):
    threaded = False        # progress is made by step(), like the
    # virtual clock: handle.wait drives the drain loop

    def __init__(self, registry: JobRegistry, bus: EventBus, *,
                 workdir: Optional[str | Path] = None,
                 pricing=None, datalake=None,
                 spawn_timeout: float = 20.0):
        self.registry = registry
        self.bus = bus
        self.pricing = pricing
        self.datalake = datalake
        self.dir = Path(workdir or os.path.join(tempfile.gettempdir(),
                                                "acai-jobs"))
        self.dir.mkdir(parents=True, exist_ok=True)
        self.spawn_timeout = spawn_timeout
        self._inflight: dict[str, int] = {}     # job_id -> launch epoch
        self._sock: Optional[socket.socket] = None
        self._rfile = None

    # -- worker lifecycle ------------------------------------------------
    def _worker_pid(self) -> Optional[int]:
        info = self.dir / "worker.json"
        if not info.exists():
            return None
        try:
            pid = int(json.loads(info.read_text())["pid"])
            os.kill(pid, 0)         # alive?
        except (ValueError, KeyError, OSError, json.JSONDecodeError):
            return None
        try:
            # a worker we spawned and never reaped stays a zombie that
            # still answers kill(pid, 0); it can't serve the socket
            with open(f"/proc/{pid}/stat") as fh:
                if fh.read().rpartition(")")[2].split()[0] == "Z":
                    return None
        except OSError:
            pass        # no procfs: fall back to the signal probe
        return pid

    def _spawn_worker(self) -> None:
        # the worker must import repro_torch from a bare interpreter: prepend
        # our src root (pytest's pythonpath config edits sys.path, not
        # the environment a child would inherit)
        src = str(Path(__file__).resolve().parents[4])
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [src] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        log = (self.dir / "worker.log").open("ab")
        subprocess.Popen(
            [sys.executable, "-m", "repro_torch.core.engine.durable.worker",
             "--dir", str(self.dir)],
            stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True,     # detach: survives engine death
            env=env)

    def _connect(self, *, spawn: bool = True) -> bool:
        if self._sock is not None:
            return True
        if self._worker_pid() is None:
            if not spawn:
                return False
            (self.dir / "worker.json").unlink(missing_ok=True)
            self._spawn_worker()
        sock_path = self.dir / "sock"
        deadline = time.monotonic() + self.spawn_timeout
        while time.monotonic() < deadline:
            if sock_path.exists() and self._worker_pid() is not None:
                try:
                    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    s.connect(str(sock_path))
                    self._sock = s
                    self._rfile = s.makefile("r")
                    return True
                except OSError:
                    pass
            elif not spawn and self._worker_pid() is None:
                return False    # probing only: the worker is simply gone
            time.sleep(0.05)
        if not spawn:
            return False
        raise RuntimeError(f"worker at {self.dir} did not come up within "
                           f"{self.spawn_timeout}s")

    def _send(self, msg: dict) -> None:
        payload = (json.dumps(msg, default=str) + "\n").encode()
        self._connect()
        try:
            self._sock.sendall(payload)
        except OSError:
            # a cached connection can be stale (the worker it reached
            # exited since): reconnect — respawning if needed — and
            # retry once before giving up
            self._disconnect()
            self._connect()
            try:
                self._sock.sendall(payload)
            except OSError:
                self._disconnect()
                raise

    def _disconnect(self) -> None:
        if self._rfile is not None:
            try:
                self._rfile.close()
            except OSError:
                pass
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._rfile = None

    # -- Runner protocol -------------------------------------------------
    def launch(self, job: Job) -> None:
        epoch = job.epoch
        try:
            self.registry.set_state(job.job_id, JobState.RUNNING)
        except IllegalTransition:
            # killed between dispatch and pickup: surface the terminal
            self.registry.persist_state(job.job_id)
            self.bus.publish(TOPIC_CONTAINER_STATUS,
                             {"job_id": job.job_id, "epoch": epoch,
                              "status": self.registry.get(
                                  job.job_id).state.value})
            return
        self.bus.publish(TOPIC_CONTAINER_STATUS,
                         {"job_id": job.job_id, "status": "provisioned"})
        fn_ref = encode_fn(job.spec.fn)
        if fn_ref is None:
            err = (f"{job.job_id}: SubprocessRunner needs an importable "
                   f"module-level fn (got "
                   f"{getattr(job.spec.fn, '__qualname__', None)!r}); "
                   f"lambdas/closures cannot cross the process boundary")
            self._fail_local(job, epoch, err)
            return
        self._send({"op": "launch", "job": job.job_id, "epoch": epoch,
                    "fn": fn_ref, "name": job.spec.name,
                    "args": json_safe(job.spec.args),
                    "resources": json_safe(job.spec.resources),
                    "workdir": str(self.dir / "jobs" / job.job_id)})
        self._inflight[job.job_id] = epoch

    def _fail_local(self, job: Job, epoch: int, err: str, *,
                    transient: bool = False) -> None:
        if self.registry.set_state(job.job_id, JobState.FAILED, error=err,
                                   expect_epoch=epoch) is None:
            return
        job.outputs["log"] = err
        self.registry.persist_state(job.job_id)
        if self.datalake is not None:
            # no worker log exists for an engine-side failure: persist
            # the reason as the job log so `acai logs` can answer "why"
            self.datalake.storage.upload(f"/.logs/{job.job_id}.log",
                                         err.encode(),
                                         creator=job.spec.user)
        msg = {"job_id": job.job_id, "epoch": epoch, "status": "FAILED"}
        if transient:
            msg["transient"] = True
        self.bus.publish(TOPIC_CONTAINER_STATUS, msg)

    def pending(self) -> int:
        return len(self._inflight)

    def step(self, timeout: float = 120.0) -> Optional[str]:
        """Block for the next worker push and apply it; returns the
        settled job id (None on an idle/ignored message)."""
        if not self._inflight:
            return None
        self._connect()
        self._sock.settimeout(timeout)
        try:
            line = self._rfile.readline()
        except socket.timeout:
            raise TimeoutError(f"no worker event within {timeout}s "
                               f"({len(self._inflight)} in flight)") \
                from None
        finally:
            self._sock.settimeout(None)
        if not line:
            # worker died underneath us: fail what it was running (its
            # buffered results were already consumed at adopt/connect)
            self._disconnect()
            lost = list(self._inflight.items())
            self._inflight.clear()
            for jid, epoch in lost:
                try:
                    job = self.registry.get(jid)
                except KeyError:
                    continue
                # the worker died, not the job: a transient failure, so
                # a retry budget can relaunch on a fresh worker
                self._fail_local(job, epoch,
                                 f"{jid}: worker process died mid-run",
                                 transient=True)
            return None
        msg = json.loads(line)
        if msg.get("op") != "terminal":
            return None
        try:
            job = self.registry.get(msg.get("job", ""))
        except KeyError:
            return None
        return msg["job"] if self.apply_result(job, msg) else None

    # -- result application (shared with recovery) -----------------------
    def apply_result(self, job: Job, msg: dict, *,
                     publish: bool = True) -> bool:
        """Epoch-guarded, idempotent terminal apply. Returns False when
        the result is stale (superseded epoch) or a duplicate (job
        already terminal) — exactly-once settle under at-least-once
        delivery from the worker's replayed buffer."""
        jid = job.job_id
        epoch = msg.get("epoch")
        epoch = int(epoch) if epoch is not None else None
        if job.state in TERMINAL_STATES:
            self._inflight.pop(jid, None)
            return False
        try:
            state = JobState(msg.get("status", "FAILED"))
        except ValueError:
            state = JobState.FAILED
        try:
            committed = self.registry.set_state(jid, state,
                                                error=msg.get("error"),
                                                expect_epoch=epoch)
        except IllegalTransition:
            committed = None    # e.g. re-queued (QUEUED) under a new
            # epoch while this stale result was in the buffer
        if committed is None:
            if self._inflight.get(jid) == epoch:
                self._inflight.pop(jid, None)
            return False
        job.runtime = msg.get("runtime")
        job.outputs.update(dict(msg.get("outputs") or {}))
        log = msg.get("log", "")
        if state == JobState.FAILED and msg.get("error"):
            # the worker's traceback belongs in the job log: stdout alone
            # rarely explains a failure, and the data-lake log is what
            # `acai logs <job>` reads cross-process
            log = (log + "\n" if log else "") + str(msg["error"])
        job.outputs["log"] = log
        if job.runtime:
            _bill_segment(resolve_pricing(self.pricing, job), job,
                          job.runtime)
        if self.datalake is not None:
            # the job's [[acai:key=value]] metrics, as the in-process
            # runners record them (the reference's runner drops them)
            meta = parse_log(log)
            if meta:
                self.datalake.metadata.put(jid, **meta)
            extra = {}
            if job.error:
                extra["error"] = \
                    str(job.error).strip().splitlines()[-1][:200]
            if job.retries:
                extra["retries"] = job.retries
            self.datalake.metadata.put(jid, runtime=job.runtime,
                                       cost=job.cost, state=state.value,
                                       **extra)
            self.datalake.storage.upload(f"/.logs/{jid}.log",
                                         job.outputs["log"].encode(),
                                         creator=job.spec.user)
        self._inflight.pop(jid, None)
        if publish:
            out = {"job_id": jid, "status": state.value}
            if epoch is not None:
                out["epoch"] = epoch
            if msg.get("transient") and state == JobState.FAILED:
                out["transient"] = True
            if msg.get("error"):
                out["error"] = str(msg["error"])
            self.bus.publish(TOPIC_CONTAINER_STATUS, out)
        return True

    # -- restart adoption ------------------------------------------------
    def adopt(self) -> tuple[dict[str, int], list[dict]]:
        """Reconnect to a surviving worker; returns ``(in-flight
        {job_id: epoch}, buffered result records)``. The in-flight set is
        re-registered so ``pending()/step()`` keep draining it; with no
        surviving worker both are empty (the recovery path re-queues)."""
        if self._worker_pid() is None or not self._connect(spawn=False):
            # the worker died too: nothing is in flight, but results it
            # persisted before dying still settle without a re-run
            return {}, self._read_result_file()
        results: list[dict] = []
        inflight: dict[str, int] = {}
        adopted = False
        try:
            self._send({"op": "adopt"})
            deadline = time.monotonic() + self.spawn_timeout
            self._sock.settimeout(max(0.1, self.spawn_timeout))
            try:
                while time.monotonic() < deadline:
                    line = self._rfile.readline()
                    if not line:
                        break
                    msg = json.loads(line)
                    if msg.get("op") == "terminal":
                        results.append(msg)  # completion racing the adopt
                        continue
                    if msg.get("op") == "adopted":
                        inflight = {r["job"]: int(r.get("epoch", 0))
                                    for r in msg.get("inflight", ())}
                        results.extend(msg.get("results", ()))
                        adopted = True
                        break
            finally:
                if self._sock is not None:
                    self._sock.settimeout(None)
        except (socket.timeout, OSError):
            pass
        if not adopted:
            # the worker died out from under the handshake (e.g. it was
            # mid-shutdown and still answered the liveness probe, or a
            # not-yet-reaped zombie): drop the stale connection and fall
            # back to its durable result buffer, exactly as for an
            # already-dead worker
            self._disconnect()
            return {}, self._read_result_file()
        self._inflight.update(inflight)
        return inflight, results

    def _read_result_file(self) -> list[dict]:
        path = self.dir / "results.jsonl"
        if not path.exists():
            return []
        out = []
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    break       # torn tail from the worker's own death
                raise
        return out

    def shutdown(self) -> None:
        """Stop the worker (best-effort) and drop the connection."""
        try:
            if self._worker_pid() is not None:
                self._send({"op": "shutdown"})
        except (OSError, RuntimeError):
            pass
        self._disconnect()
