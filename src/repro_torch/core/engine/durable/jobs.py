"""Importable job payloads for the process-boundary runner.

``SubprocessRunner`` serializes job fns as ``module:qualname``
references, so tests, the crash drill and CLI examples need module-level
callables a bare worker interpreter can import. Each follows the engine
contract ``fn(workdir: Path, job) -> dict``.

A copy of ``repro/core/engine/durable/jobs.py``, with ``chatty_job`` added.
The card's payloads, which import torch, are in
``repro_torch/examples/card_jobs.py``.
"""
from __future__ import annotations

import time
from pathlib import Path


def echo_job(workdir: Path, job) -> dict:
    """Return (and print) the submitted message."""
    msg = job.spec.args.get("msg", "hello")
    print(f"echo: {msg}")
    return {"echo": msg}


def sleep_job(workdir: Path, job) -> dict:
    """Sleep ``args['seconds']`` — in-flight fodder for crash tests."""
    seconds = float(job.spec.args.get("seconds", 0.1))
    time.sleep(seconds)
    return {"slept": seconds}


def append_once_job(workdir: Path, job) -> dict:
    """Append one line to ``args['path']`` — a side-effect counter: the
    exactly-once tests assert the file has one line per job id no matter
    how many times the engine crashed and recovered around it."""
    path = Path(job.spec.args["path"])
    delay = float(job.spec.args.get("seconds", 0.0))
    if delay:
        time.sleep(delay)
    with path.open("a") as fh:
        fh.write(f"{job.job_id}\n")
    return {"marked": job.job_id}


def chatty_job(workdir: Path, job) -> dict:
    """Print ``args['lines']`` lines tagged with ``args['tag']``,
    ``args['interval']`` seconds apart: two of these that overlap show
    whether each job's log holds its own lines only."""
    tag = job.spec.args.get("tag", job.job_id)
    lines = int(job.spec.args.get("lines", 20))
    interval = float(job.spec.args.get("interval", 0.01))
    for i in range(lines):
        print(f"{tag} {i}")
        time.sleep(interval)
    return {"lines": lines}


def fail_job(workdir: Path, job) -> dict:
    """Fail deterministically."""
    raise RuntimeError(job.spec.args.get("msg", "deliberate failure"))
