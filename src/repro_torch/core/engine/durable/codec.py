"""JSON codec for every spec/event shape the journal persists.

A copy of ``repro/core/engine/durable/codec.py``, with its imports in
``repro_torch.core``.

Specs and jobs must round-trip through the store and back into live
objects: ``encode_spec``/``decode_spec`` cover ``JobSpec`` including the
nested ``GangSpec`` and per-pool resource menus, ``encode_job``/
``decode_job`` cover the full ``Job`` record (epoch, preemptions, gang
width, outputs), and ``encode_transfer_costs`` flattens the
``TransferCostModel``'s tuple-keyed pair table into JSON-safe rows.

The one lossy field is ``JobSpec.fn``: a callable cannot cross a process
boundary, so it is serialized as an importable ``"module:qualname"``
reference. Lambdas and local functions encode to ``None`` — a virtual
job (``spec.duration``) recovers fine without its fn; a real job whose
fn is gone decodes to a stub that FAILs loudly at launch instead of
silently "finishing" as a no-op.
"""
from __future__ import annotations

import importlib
import math
from typing import Any, Callable, Optional

from repro_torch.core.engine.lifecycle import JobState
from repro_torch.core.engine.registry import GangSpec, Job, JobSpec, RetryPolicy


# -- fn references -------------------------------------------------------
def encode_fn(fn: Optional[Callable]) -> Optional[str]:
    """``"module:qualname"`` when the callable is importable from a fresh
    process, else None (lambdas, closures, REPL functions)."""
    if fn is None:
        return None
    mod = getattr(fn, "__module__", None)
    qual = getattr(fn, "__qualname__", None)
    if not mod or not qual or "<" in qual:      # <lambda>, <locals>
        return None
    return f"{mod}:{qual}"


def _unresolvable(ref: str) -> Callable:
    def _fail(workdir, job):
        raise RuntimeError(
            f"job fn {ref!r} is not importable in this process; "
            f"re-submit with an importable module-level callable")
    _fail.__qualname__ = "<unresolvable>"
    return _fail


def decode_fn(ref: Optional[str]) -> Optional[Callable]:
    if ref is None:
        return None
    mod, _, qual = ref.partition(":")
    try:
        obj: Any = importlib.import_module(mod)
        for part in qual.split("."):
            obj = getattr(obj, part)
        return obj
    except Exception:
        return _unresolvable(ref)


# -- JSON safety ---------------------------------------------------------
def json_safe(obj: Any) -> Any:
    """Recursively coerce to JSON-representable values (non-finite floats
    and arbitrary objects become strings); dict keys become strings."""
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else str(obj)
    if isinstance(obj, dict):
        return {str(k): json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [json_safe(v) for v in obj]
    return str(obj)


# -- GangSpec ------------------------------------------------------------
def encode_gang(gang: Optional[GangSpec]) -> Optional[dict]:
    if gang is None:
        return None
    return {"n_pods": gang.n_pods,
            "per_pod_resources": json_safe(gang.per_pod_resources),
            "topology": gang.topology,
            "min_pods": gang.min_pods}


def decode_gang(doc: Optional[dict]) -> Optional[GangSpec]:
    if doc is None:
        return None
    return GangSpec(n_pods=int(doc["n_pods"]),
                    per_pod_resources=doc.get("per_pod_resources"),
                    topology=doc.get("topology", "any"),
                    min_pods=int(doc.get("min_pods", 0)))


# -- RetryPolicy ---------------------------------------------------------
def encode_retry(retry: Optional[RetryPolicy]) -> Optional[dict]:
    if retry is None:
        return None
    return {"max_retries": retry.max_retries,
            "backoff_base": retry.backoff_base,
            "backoff_cap": retry.backoff_cap,
            "retry_on": retry.retry_on}


def decode_retry(doc: Optional[dict]) -> Optional[RetryPolicy]:
    if doc is None:
        return None
    return RetryPolicy(max_retries=int(doc.get("max_retries", 3)),
                       backoff_base=float(doc.get("backoff_base", 1.0)),
                       backoff_cap=float(doc.get("backoff_cap", 60.0)),
                       retry_on=doc.get("retry_on", "transient"))


# -- JobSpec -------------------------------------------------------------
def encode_spec(spec: JobSpec) -> dict:
    return {
        "name": spec.name,
        "project": spec.project,
        "user": spec.user,
        "fn": encode_fn(spec.fn),
        "argv": list(spec.argv) if spec.argv is not None else None,
        "input_fileset": spec.input_fileset,
        "output_fileset": spec.output_fileset,
        "resources": json_safe(spec.resources),
        "args": json_safe(spec.args),
        "duration": spec.duration,
        "priority": spec.priority,
        "depends_on": list(spec.depends_on or ()),
        "pool": spec.pool,
        "pool_resources": json_safe(spec.pool_resources),
        "template": spec.template,
        "gang": encode_gang(spec.gang),
        "input_bytes": spec.input_bytes,
        "retry": encode_retry(getattr(spec, "retry", None)),
        "timeout_s": getattr(spec, "timeout_s", None),
        "deadline": getattr(spec, "deadline", None),
    }


def decode_spec(doc: dict) -> JobSpec:
    return JobSpec(
        name=doc["name"],
        project=doc.get("project", ""),
        user=doc.get("user", ""),
        fn=decode_fn(doc.get("fn")),
        argv=doc.get("argv"),
        input_fileset=doc.get("input_fileset"),
        output_fileset=doc.get("output_fileset"),
        resources=dict(doc.get("resources") or {}),
        args=dict(doc.get("args") or {}),
        duration=doc.get("duration"),
        priority=int(doc.get("priority", 0)),
        depends_on=list(doc.get("depends_on") or ()),
        pool=doc.get("pool"),
        pool_resources={p: dict(r) for p, r in
                        (doc.get("pool_resources") or {}).items()},
        template=doc.get("template"),
        gang=decode_gang(doc.get("gang")),
        input_bytes=float(doc.get("input_bytes", 0.0)),
        retry=decode_retry(doc.get("retry")),
        timeout_s=doc.get("timeout_s"),
        deadline=doc.get("deadline"),
    )


# -- Job (snapshot records) ----------------------------------------------
def encode_job(job: Job) -> dict:
    return {
        "job_id": job.job_id,
        "spec": encode_spec(job.spec),
        "state": job.state.value,
        "submitted_at": job.submitted_at,
        "started_at": job.started_at,
        "finished_at": job.finished_at,
        "runtime": job.runtime,
        "cost": job.cost,
        "pool": job.pool,
        "error": job.error,
        "outputs": json_safe(job.outputs),
        "epoch": job.epoch,
        "preemptions": job.preemptions,
        "gang_pods": job.gang_pods,
        "retries": job.retries,
        "failures": job.failures,
    }


def decode_job(doc: dict) -> Job:
    job = Job(job_id=doc["job_id"], spec=decode_spec(doc["spec"]),
              state=JobState(doc.get("state", "SUBMITTED")))
    job.submitted_at = doc.get("submitted_at") or job.submitted_at
    job.started_at = doc.get("started_at")
    job.finished_at = doc.get("finished_at")
    job.runtime = doc.get("runtime")
    job.cost = doc.get("cost")
    job.pool = doc.get("pool")
    job.error = doc.get("error")
    job.outputs = dict(doc.get("outputs") or {})
    job.epoch = int(doc.get("epoch", 0))
    job.preemptions = int(doc.get("preemptions", 0))
    gp = doc.get("gang_pods")
    job.gang_pods = int(gp) if gp is not None else None
    job.retries = int(doc.get("retries", 0))
    job.failures = int(doc.get("failures", 0))
    return job


# -- FaultPlan -----------------------------------------------------------
def encode_fault_plan(plan) -> Optional[dict]:
    if plan is None:
        return None
    return {"seed": plan.seed,
            "node_mtbf_s": plan.node_mtbf_s,
            "transient_mtbf_s": plan.transient_mtbf_s,
            "straggler_mtbf_s": plan.straggler_mtbf_s,
            "straggler_factor": plan.straggler_factor,
            "start": plan.start,
            "max_node_failures": plan.max_node_failures}


def decode_fault_plan(doc: Optional[dict]):
    if doc is None:
        return None
    from repro_torch.core.engine.faults import FaultPlan
    mnf = doc.get("max_node_failures")
    return FaultPlan(
        seed=int(doc.get("seed", 0)),
        node_mtbf_s=doc.get("node_mtbf_s"),
        transient_mtbf_s=doc.get("transient_mtbf_s"),
        straggler_mtbf_s=doc.get("straggler_mtbf_s"),
        straggler_factor=float(doc.get("straggler_factor", 4.0)),
        start=float(doc.get("start", 0.0)),
        max_node_failures=int(mnf) if mnf is not None else None)


# -- TransferCostModel ---------------------------------------------------
def encode_transfer_costs(model) -> dict:
    """Flatten a ``TransferCostModel``: the pair table is keyed by
    ``(src_pool, dst_pool)`` tuples, which JSON cannot key — store it as
    ``[src, dst, rate]`` rows instead."""
    return {
        "cost_per_gb": model.cost_per_gb,
        "pair_cost_per_gb": [[s, d, r] for (s, d), r in
                             sorted(model.pair_cost_per_gb.items())],
        "interconnect_weight": model.interconnect_weight,
    }


def decode_transfer_costs(doc: dict):
    from repro_torch.core.engine.placement import TransferCostModel
    return TransferCostModel(
        cost_per_gb=float(doc.get("cost_per_gb", 0.0)),
        pair_cost_per_gb={(s, d): float(r) for s, d, r in
                          (doc.get("pair_cost_per_gb") or ())},
        interconnect_weight=float(doc.get("interconnect_weight", 1.0)))
