"""Standalone job worker: the far side of the process boundary.

    python -m repro_torch.core.engine.durable.worker --dir <worker-dir>

The worker owns a Unix-domain socket (``<dir>/sock``) speaking
newline-delimited JSON and advertises itself in ``<dir>/worker.json``.
It is spawned detached (own session) by :class:`SubprocessRunner`, so it
**outlives the engine**: jobs keep running through an engine crash, and
a restarted engine reconnects and re-adopts them.

Request ops (engine -> worker)::

    {"op": "launch", "job", "epoch", "fn", "name", "args", "workdir"}
    {"op": "adopt"}                 # -> in-flight set + buffered results
    {"op": "ping"}                  # -> {"op": "pong", ...}
    {"op": "shutdown"}

Push ops (worker -> engine)::

    {"op": "terminal", "job", "epoch", "status", "outputs", "error",
     "runtime", "log"}

Every completion is appended to ``<dir>/results.jsonl`` *before* it is
pushed — the file is the durable truth. If no engine is connected when a
job finishes, the result simply waits there; ``adopt`` replays the whole
buffer and the engine's epoch-guarded apply drops what it already knows
(at-least-once delivery, exactly-once settle). Duplicate ``launch`` for
a (job, epoch) already running or already completed is idempotent: the
worker ignores the re-run and re-pushes the buffered result instead.

A copy of ``repro/core/engine/durable/worker.py``, with its imports in
``repro_torch.core``, and two of the reference's faults fixed (ROADMAP C):

- **The runtime covers the job's device work.** The reference reads the
  clock as soon as the fn returns, so a job that returns with CUDA work
  queued would be billed and profiled for its launches only. Here, once
  CUDA is initialised in the worker, the runtime is read after the job's
  stream has finished (``jobthread.elapsed``), as the port's thread runner
  does.
- **Each job's log holds its own lines.** The reference runs each job on a
  thread of its own under a process-wide ``redirect_stdout``, so the logs
  of overlapping jobs mix. Here each thread's stdout is captured apart
  (``jobthread.capture_stdout``), as the thread runner's is.

Each job thread runs on a CUDA stream of its own, which first waits for the
default stream's queued work, once CUDA is initialised at the job's start
(a job that initialises CUDA itself runs on the default stream, and its
runtime waits for that); the streams are kept and handed to later jobs.
The worker imports torch only for that, and only once a job has imported
it and initialised CUDA, so a worker of CPU jobs never loads torch and its
records are the reference's. A worker keeps its CUDA context and its
allocator's cache until it exits.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import socket
import sys
import threading
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

from repro_torch.core.engine.jobthread import (capture_stdout, cuda,
                                               elapsed, on_stream)


class _Worker:
    def __init__(self, root: Path):
        self.root = root
        self.root.mkdir(parents=True, exist_ok=True)
        self.results_path = root / "results.jsonl"
        self._lock = threading.Lock()
        self._running: dict[str, int] = {}      # job_id -> epoch
        self._done: dict[str, dict] = {}        # job_id -> result record
        self._conn: socket.socket | None = None
        self._stop = threading.Event()
        self._streams: list = []       # idle CUDA streams, for later jobs
        for rec in self._read_results():
            self._done[rec["job"]] = rec

    # -- durable result buffer ------------------------------------------
    def _read_results(self) -> list[dict]:
        if not self.results_path.exists():
            return []
        out = []
        lines = self.results_path.read_text().splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    break       # torn tail: the job will re-run
                raise
        return out

    def _record_result(self, rec: dict) -> None:
        with self._lock:
            self._done[rec["job"]] = rec
            with self.results_path.open("a") as fh:
                fh.write(json.dumps(rec, default=str) + "\n")
                fh.flush()

    # -- push channel ----------------------------------------------------
    def _send(self, msg: dict) -> None:
        with self._lock:
            conn = self._conn
        if conn is None:
            return
        try:
            conn.sendall((json.dumps(msg, default=str) + "\n").encode())
        except OSError:
            pass        # engine gone; results.jsonl keeps the truth

    # -- job execution ---------------------------------------------------
    def _take_stream(self):
        """A CUDA stream for a job starting now: None while CUDA is not
        initialised in this process."""
        torch = cuda()
        if torch is None:
            return None
        with self._lock:
            if self._streams:
                return self._streams.pop()
        return torch.cuda.Stream()

    def _give_back(self, stream) -> None:
        if stream is not None:
            with self._lock:
                self._streams.append(stream)

    def _run_job(self, req: dict) -> None:
        jid, epoch = req["job"], int(req.get("epoch", 0))
        workdir = Path(req.get("workdir") or (self.root / "jobs" / jid))
        (workdir / "out").mkdir(parents=True, exist_ok=True)
        log_buf = io.StringIO()
        rec = {"op": "terminal", "job": jid, "epoch": epoch,
               "status": "FINISHED", "outputs": {}, "error": None,
               "runtime": None, "log": ""}
        stream = self._take_stream()
        t0 = time.perf_counter()
        try:
            from repro_torch.core.engine.durable.codec import (decode_fn,
                                                               json_safe)
            fn = decode_fn(req.get("fn"))
            if fn is None:
                raise RuntimeError("launch carried no fn reference")
            shim = SimpleNamespace(
                job_id=jid, epoch=epoch, preempt_flag=None,
                spec=SimpleNamespace(name=req.get("name", jid),
                                     args=dict(req.get("args") or {}),
                                     resources=dict(req.get("resources")
                                                    or {})))
            with capture_stdout(log_buf), on_stream(stream):
                result = fn(workdir, shim)
            rec["runtime"] = elapsed(t0, stream)
            rec["outputs"] = json_safe(result) \
                if isinstance(result, dict) else {}
        except Exception as e:  # noqa: BLE001 — user code failure => FAILED
            rec["status"] = "FAILED"
            rec["error"] = traceback.format_exc()
            rec["runtime"] = elapsed(t0, stream, quiet=True)
            # job-classified retryable failures (TransientJobError, by
            # name — the worker must not import the engine stack just to
            # isinstance-check) ride the record so the engine's retry
            # policy can distinguish flaky from fatal across the boundary
            if any(t.__name__ == "TransientJobError"
                   for t in type(e).__mro__):
                rec["transient"] = True
        self._give_back(stream)
        rec["log"] = log_buf.getvalue()
        with self._lock:
            self._running.pop(jid, None)
        self._record_result(rec)
        self._send(rec)

    # -- request handling ------------------------------------------------
    def _handle(self, req: dict) -> dict | None:
        op = req.get("op")
        if op == "launch":
            jid = req["job"]
            with self._lock:
                running = jid in self._running
                done = self._done.get(jid)
            if running:
                return None         # duplicate launch: already in flight
            if done is not None and \
                    int(done.get("epoch", 0)) >= int(req.get("epoch", 0)):
                self._send(done)    # already completed: replay the result
                return None
            with self._lock:
                self._running[jid] = int(req.get("epoch", 0))
            threading.Thread(target=self._run_job, args=(req,),
                             daemon=False).start()
            return None
        if op == "adopt":
            with self._lock:
                inflight = [{"job": j, "epoch": e}
                            for j, e in self._running.items()]
                results = list(self._done.values())
            return {"op": "adopted", "inflight": inflight,
                    "results": results}
        if op == "ping":
            with self._lock:
                n = len(self._running)
            return {"op": "pong", "pid": os.getpid(), "inflight": n}
        if op == "shutdown":
            self._stop.set()
            return {"op": "bye"}
        return {"op": "error", "error": f"unknown op {op!r}"}

    def _serve_conn(self, conn: socket.socket) -> None:
        with self._lock:
            old, self._conn = self._conn, conn
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        rfile = conn.makefile("r")
        try:
            for line in rfile:
                if not line.strip():
                    continue
                try:
                    reply = self._handle(json.loads(line))
                except Exception:   # noqa: BLE001
                    reply = {"op": "error", "error": traceback.format_exc()}
                if reply is not None:
                    try:
                        conn.sendall((json.dumps(reply, default=str)
                                      + "\n").encode())
                    except OSError:
                        break
                if self._stop.is_set():
                    break
        finally:
            with self._lock:
                if self._conn is conn:
                    self._conn = None
            try:
                conn.close()
            except OSError:
                pass

    def serve(self) -> None:
        sock_path = self.root / "sock"
        if sock_path.exists():
            sock_path.unlink()
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(str(sock_path))
        srv.listen(2)
        srv.settimeout(0.5)
        info = self.root / "worker.json"
        tmp = info.with_suffix(".json.tmp")
        tmp.write_text(json.dumps({"pid": os.getpid(),
                                   "sock": str(sock_path)}))
        os.replace(tmp, info)
        while not self._stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()
        # wait for in-flight jobs so their results land in the buffer
        while True:
            with self._lock:
                if not self._running:
                    break
            time.sleep(0.05)
        srv.close()
        # retire the advert: a graceful exit must not leave a stale
        # pid/socket for the next engine's liveness probe to trip over —
        # but only if it is still *ours* (a replacement worker may have
        # re-advertised while we drained)
        try:
            mine = json.loads(info.read_text())["pid"] == os.getpid()
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            mine = False
        if mine:
            info.unlink(missing_ok=True)
            sock_path.unlink(missing_ok=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="acai-worker")
    ap.add_argument("--dir", required=True)
    args = ap.parse_args(argv)
    _Worker(Path(args.dir)).serve()
    return 0


if __name__ == "__main__":
    sys.exit(main())
