"""Pipeline DAG builder: declared dataflow over the futures SDK.

A copy of ``repro/core/engine/pipeline.py``, with its imports
in ``repro_torch.core``.

The paper's headline workflow is the *vertical pipeline* — ETL -> train ->
eval chained through file sets — fanned out *horizontally* across a config
sweep (§1, §3, §5.2). ``Pipeline`` lets users declare exactly that:

    pipe = engine.pipeline("sweep")
    etl = pipe.stage(JobSpec(..., output_fileset="TrainSet"))
    runs = pipe.map(lambda p: JobSpec(..., input_fileset="TrainSet",
                                      output_fileset=f"model-{p['lr']}"),
                    {"lr": [0.5, 0.1], "hidden": [8, 16]})
    report = pipe.stage(JobSpec(...), after=runs)
    handles = pipe.run()            # JobHandle per stage, DAG-gated

Edges come from two sources, merged and deduplicated:
  * explicit ``after=[stage, ...]`` declarations, and
  * inferred dataflow — a stage whose ``input_fileset`` names another
    stage's ``output_fileset`` depends on that producer.

``run()`` topologically sorts the stages (cycles are rejected), stamps
each spec's ``depends_on`` with the parent job ids, and submits; the
scheduler holds children until every parent FINISHES and cascades
UPSTREAM_FAILED otherwise. Each declared edge is also recorded in the
project's ProvenanceGraph (action="pipeline_dep"), so lineage reflects the
*declared* dataflow, not just observed reads/writes.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, Optional, Union

from repro_torch.core.engine.handle import JobHandle, wait_all
from repro_torch.core.engine.lifecycle import JobState
from repro_torch.core.engine.registry import GangSpec, JobSpec


class Stage:
    """One node of the pipeline DAG; resolves to a JobHandle after run()."""

    def __init__(self, spec: JobSpec, after: list["Stage"]):
        self.spec = spec
        self.after = after
        self.handle: Optional[JobHandle] = None

    @property
    def job_id(self) -> Optional[str]:
        return self.handle.job_id if self.handle is not None else None

    def __repr__(self) -> str:
        state = self.handle.status().value if self.handle else "declared"
        return f"Stage({self.spec.name!r}, {state})"


StageOrStages = Union[Stage, Iterable[Stage]]


class Pipeline:
    def __init__(self, engine, *, name: str = "pipeline",
                 submit: Optional[Callable[..., JobHandle]] = None):
        self._engine = engine
        self.name = name
        self._submit = submit or \
            (lambda spec: engine.submit(spec, pipeline=name))
        self._stages: list[Stage] = []
        self._ran = False

    # -- declaration -----------------------------------------------------
    def stage(self, spec: JobSpec, after: StageOrStages = (),
              gang: Union[int, GangSpec, None] = None) -> Stage:
        """Declare one stage; ``after`` adds explicit dependency edges on
        previously declared stages (dataflow edges are inferred anyway).

        ``gang=n`` makes the stage a co-scheduled gang of ``n`` pods, each
        with the spec's ``resources`` shape (sharded multi-host training
        next to single-pod sweep jobs, in one pipeline); pass a
        :class:`GangSpec` for per-pod overrides, topology hints, or an
        elastic ``min_pods`` floor.
        """
        if self._ran:
            raise RuntimeError("pipeline already ran; declare a new one")
        if gang is not None:
            spec.gang = gang if isinstance(gang, GangSpec) \
                else GangSpec(n_pods=int(gang))
        after = [after] if isinstance(after, Stage) else list(after)
        for parent in after:
            if parent not in self._stages:
                raise ValueError(
                    f"after= references a stage not in pipeline "
                    f"{self.name!r}: {parent!r}")
        st = Stage(spec, after)
        self._stages.append(st)
        return st

    def map(self, spec_fn: Callable[[dict[str, Any]], JobSpec],
            grid: Union[dict[str, Iterable], Iterable[dict[str, Any]]],
            after: StageOrStages = (),
            gang: Union[int, GangSpec, None] = None) -> list[Stage]:
        """Horizontal fan-out: one stage per grid point.

        ``grid`` is either a dict of value-lists (cartesian product, the
        hyperparameter-sweep case) or an explicit iterable of param dicts;
        ``spec_fn(params)`` builds each stage's JobSpec. ``gang`` applies
        to every fanned-out stage (see :meth:`stage`).
        """
        if isinstance(grid, dict):
            keys = list(grid)
            combos = [dict(zip(keys, vals))
                      for vals in itertools.product(*(grid[k] for k in keys))]
        else:
            combos = [dict(g) for g in grid]
        return [self.stage(spec_fn(params), after=after, gang=gang)
                for params in combos]

    # -- DAG assembly ----------------------------------------------------
    def _parents(self) -> dict[int, list[Stage]]:
        """Explicit ``after`` edges + inferred fileset-dataflow edges,
        deduplicated, keyed by id(stage)."""
        producers: dict[str, list[Stage]] = {}
        for st in self._stages:
            if st.spec.output_fileset:
                producers.setdefault(st.spec.output_fileset, []).append(st)
        parents: dict[int, list[Stage]] = {}
        for st in self._stages:
            ps = list(st.after)
            if st.spec.input_fileset:
                ps += [p for p in producers.get(st.spec.input_fileset, [])
                       if p is not st]
            seen: set[int] = set()
            parents[id(st)] = [p for p in ps if not
                               (id(p) in seen or seen.add(id(p)))]
        return parents

    def run(self) -> list[JobHandle]:
        """Submit every stage (topological order), returning handles in
        declaration order. Raises ValueError on a dependency cycle."""
        if self._ran:
            raise RuntimeError("pipeline already ran")
        parents = self._parents()
        remaining = list(self._stages)
        done: set[int] = set()
        order: list[Stage] = []
        while remaining:
            ready = [st for st in remaining
                     if all(id(p) in done for p in parents[id(st)])]
            if not ready:
                cyc = ", ".join(st.spec.name for st in remaining)
                raise ValueError(
                    f"pipeline {self.name!r} has a dependency cycle "
                    f"among: {cyc}")
            for st in ready:
                order.append(st)
                done.add(id(st))
            remaining = [st for st in remaining if id(st) not in done]
        for st in order:
            dep_ids = [p.handle.job_id for p in parents[id(st)]]
            merged = list(st.spec.depends_on or []) + dep_ids
            st.spec.depends_on = list(dict.fromkeys(merged))
            st.handle = self._submit(st.spec)
        self._ran = True
        return self.handles

    # -- resolution ------------------------------------------------------
    @property
    def handles(self) -> list[JobHandle]:
        return [st.handle for st in self._stages if st.handle is not None]

    def wait(self, timeout: Optional[float] = None) -> list[JobState]:
        """Resolve every stage; returns terminal states in declaration
        order."""
        if not self._ran:
            raise RuntimeError("pipeline.run() first")
        return wait_all(self.handles, timeout)
