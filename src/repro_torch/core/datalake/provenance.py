"""Provenance graph (ACAI §3.2.4, §4.5.2); a copy of
``repro/core/datalake/provenance.py`` without networkx.

A DAG where nodes are file-set versions and edges are actions — job
executions or file-set creations. The paper hosts this on Neo4j storing only
ids (metadata lives in the metadata server). The reference keeps a
``networkx.MultiDiGraph``; this copy keeps the same multigraph as
insertion-ordered dicts (``_succ[u][v]`` and ``_pred[v][u]`` share one list
of edge-data dicts per (u, v), in insertion order), writes the same
``provenance.json`` and answers every query with the reference's results in
the reference's order.

Edge direction follows dataflow: input fileset --(job)--> output fileset,
source fileset --(creation)--> derived fileset.
"""
from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Optional

from repro_torch.core.datalake.storage import DataLakeError


class ProvenanceGraph:
    def __init__(self, root: str | Path):
        self._path = Path(root) / "provenance.json"
        # job agents on ThreadPoolRunner workers add edges concurrently
        self._lock = threading.RLock()
        self._succ: dict[str, dict[str, list[dict]]] = {}
        self._pred: dict[str, dict[str, list[dict]]] = {}
        if self._path.exists():
            raw = json.loads(self._path.read_text())
            for n in raw["nodes"]:
                self._add_node(n)
            for u, v, data in raw["edges"]:
                self._add_edge(u, v, **data)

    def _add_node(self, n: str) -> None:
        if n not in self._succ:
            self._succ[n] = {}
            self._pred[n] = {}

    def _add_edge(self, u: str, v: str, **data) -> None:
        self._add_node(u)
        self._add_node(v)
        if v not in self._succ[u]:
            self._succ[u][v] = self._pred[v][u] = []
        self._succ[u][v].append(dict(data))

    def _edges(self) -> list[tuple[str, str, dict]]:
        return [(u, v, d) for u, nbrs in self._succ.items()
                for v, ds in nbrs.items() for d in ds]

    def _save(self) -> None:
        raw = {"nodes": list(self._succ), "edges": self._edges()}
        self._path.write_text(json.dumps(raw))

    # ------------------------------------------------------------------
    def add_fileset(self, fileset_ref: str) -> None:
        with self._lock:
            self._add_node(fileset_ref)
            self._save()

    def add_job_edge(self, *, src: Optional[str], dst: str, job_id: str,
                     creator: str = "") -> None:
        """input fileset --(job execution)--> output fileset."""
        with self._lock:
            self._add_node(dst)
            if src is not None:
                self._add_node(src)
                self._add_edge(src, dst, action="job", job_id=job_id,
                               creator=creator)
            self._save()

    def add_dependency_edge(self, *, src_job: str, dst_job: str,
                            pipeline: str = "",
                            src_fileset: Optional[str] = None,
                            dst_fileset: Optional[str] = None) -> None:
        """Declared DAG edge from the pipeline SDK: recorded at submit
        time, before either job runs, so lineage reflects the *declared*
        dataflow (JobSpec.depends_on) and not just observed reads/writes.
        Nodes are job ids (fileset-version nodes are added later by the
        runner when outputs actually materialize)."""
        with self._lock:
            self._add_node(src_job)
            self._add_node(dst_job)
            self._add_edge(src_job, dst_job, action="pipeline_dep",
                           pipeline=pipeline, src_fileset=src_fileset,
                           dst_fileset=dst_fileset)
            self._save()

    def dependency_edges(self, pipeline: Optional[str] = None) \
            -> list[tuple[str, str, dict]]:
        """All declared DAG edges, optionally filtered by pipeline name."""
        with self._lock:
            return [(u, v, d) for u, v, d in self._edges()
                    if d.get("action") == "pipeline_dep"
                    and (pipeline is None or d.get("pipeline") == pipeline)]

    def add_creation_edge(self, *, src: str, dst: str,
                          creator: str = "") -> None:
        with self._lock:
            self._add_node(src)
            self._add_node(dst)
            self._add_edge(src, dst, action="fileset_creation",
                           creator=creator)
            self._save()

    # -- the three paper APIs -------------------------------------------
    def whole_graph(self) -> dict:
        return {"nodes": list(self._succ), "edges": self._edges()}

    def forward(self, fileset_ref: str) -> list[tuple[str, dict]]:
        """One edge forward: filesets derived from this one."""
        return [(v, d) for v, ds in self._succ.get(fileset_ref, {}).items()
                for d in ds]

    def backward(self, fileset_ref: str) -> list[tuple[str, dict]]:
        """One edge backward: filesets this one was derived from."""
        return [(u, d) for u, ds in self._pred.get(fileset_ref, {}).items()
                for d in ds]

    # -- transitive helpers (dashboard tracing, workflow replay §7.1.3) --
    def _reach(self, start: str, adj: dict) -> set[str]:
        if start not in adj:
            raise DataLakeError(f"{start} is not in the provenance graph")
        seen, todo = {start}, [start]
        while todo:
            for n in adj[todo.pop()]:
                if n not in seen:
                    seen.add(n)
                    todo.append(n)
        return seen - {start}

    def ancestors(self, fileset_ref: str) -> list[str]:
        return sorted(self._reach(fileset_ref, self._pred))

    def descendants(self, fileset_ref: str) -> list[str]:
        return sorted(self._reach(fileset_ref, self._succ))

    def _induced(self, fileset_ref: str):
        """The ancestor subgraph's node set and its iteration order.

        The reference walks ``g.subgraph(anc)``, a networkx view that
        iterates a node's neighbours (and the graph's nodes) in the order
        of its filter's ``set`` when that set has fewer than half as many
        members as the dict it filters, and in the dict's order otherwise.
        ``ordered`` does the same on the same set, built the same way, so
        the results come in the reference's order."""
        anc = set(self.ancestors(fileset_ref)) | {fileset_ref}
        keep = set(n for n in anc if n in self._succ)

        def ordered(atlas: dict) -> list[str]:
            if 2 * len(keep) < len(atlas):
                return [n for n in keep if n in atlas]
            return [n for n in atlas if n in keep]

        return ordered

    def lineage_jobs(self, fileset_ref: str) -> list[str]:
        """Every job id on any path into this fileset (reproduction
        recipe, oldest first)."""
        ordered = self._induced(fileset_ref)
        jobs = []
        for u in ordered(self._succ):
            for v in ordered(self._succ[u]):
                for d in self._succ[u][v]:
                    if d.get("action") == "job":
                        jobs.append(d["job_id"])
        return jobs

    def replay_order(self, fileset_ref: str) -> list[str]:
        """Topological order of ancestor filesets (workflow replay):
        ``nx.topological_sort``'s order, generation by generation."""
        ordered = self._induced(fileset_ref)
        nodes = ordered(self._succ)
        indegree = {v: sum(len(self._pred[v][u])
                           for u in ordered(self._pred[v])) for v in nodes}
        waiting = {v: d for v, d in indegree.items() if d > 0}
        ready = [v for v, d in indegree.items() if d == 0]
        order = []
        while ready:
            generation, ready = ready, []
            for node in generation:
                for child in ordered(self._succ[node]):
                    waiting[child] -= len(self._succ[node][child])
                    if waiting[child] == 0:
                        ready.append(child)
                        del waiting[child]
            order.extend(generation)
        if waiting:
            raise DataLakeError(f"the ancestors of {fileset_ref} hold a "
                                "cycle; they have no topological order")
        return order

    def is_dag(self) -> bool:
        indegree = {v: sum(map(len, preds.values()))
                    for v, preds in self._pred.items()}
        ready = [v for v, d in indegree.items() if d == 0]
        done = 0
        while ready:
            node = ready.pop()
            done += 1
            for child, ds in self._succ[node].items():
                indegree[child] -= len(ds)
                if indegree[child] == 0:
                    ready.append(child)
        return done == len(indegree)
