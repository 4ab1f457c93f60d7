"""Workflow replay (ACAI §7.1.3 — paper future work, implemented here).

A copy of ``repro/core/engine/replay.py``, with its imports in
``repro_torch.core``.

The provenance graph records which job produced each fileset version; since
the (input fileset, job, output fileset) triplet is immutable and the
registry keeps every JobSpec, any fileset can be regenerated by re-running
its ancestor jobs in topological order — e.g. after data cleaning deleted
intermediates, or to rebuild downstream models after an upstream update.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.engine.registry import JobSpec


class WorkflowReplayer:
    def __init__(self, project, engine):
        self.project = project
        self.engine = engine

    def plan(self, fileset_ref: str) -> list[dict]:
        """The jobs (with their original specs) needed to rebuild
        ``fileset_ref``, in execution order."""
        prov = self.project.provenance
        order = prov.replay_order(fileset_ref)
        steps = []
        for node in order:
            for src, d in prov.backward(node):
                if d.get("action") == "job" and d["job_id"] not in \
                        [s["job_id"] for s in steps]:
                    steps.append({"job_id": d["job_id"], "input": src,
                                  "output": node})
        return steps

    def replay(self, fileset_ref: str, *,
               override_input: Optional[str] = None) -> list[str]:
        """Re-run the lineage. ``override_input`` swaps the root input
        fileset (the paper's "reproduce with a different dataset, same
        code" use case). Returns the new job ids."""
        steps = self.plan(fileset_ref)
        new_ids = []
        remap: dict[str, str] = {}
        for i, step in enumerate(steps):
            old = self.engine.registry.get(step["job_id"])
            inp = step["input"]
            if i == 0 and override_input is not None:
                inp = override_input
            inp = remap.get(inp, inp)
            # jobs are submit-once: replay = a NEW job with the same spec
            spec = JobSpec(
                name=old.spec.name + "-replay",
                project=old.spec.project, user=old.spec.user,
                fn=old.spec.fn, argv=old.spec.argv,
                input_fileset=inp.split(":")[0],
                output_fileset=old.spec.output_fileset,
                resources=dict(old.spec.resources),
                args=dict(old.spec.args), duration=old.spec.duration)
            job = self.engine.submit(spec)
            new_ids.append(job.job_id)
            out = self.engine.registry.get(job.job_id).outputs.get("fileset")
            if out:
                remap[step["output"]] = out
        return new_ids
