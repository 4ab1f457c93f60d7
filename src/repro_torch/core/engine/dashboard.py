"""Dashboard (ACAI §3.4, Figs. 4–5) — terminal/markdown rendition.

A copy of ``repro/core/engine/dashboard.py``, with its imports in
``repro_torch.core``.

The paper's web dashboard has two pages: a job-history page (status,
metadata, runtime logs; filtering, sorting, pagination) and a provenance
page (whole graph + interactive fore/back tracing). Both renderers work
off the same registry/metadata/provenance state the web UI would."""
from __future__ import annotations

from typing import Optional

from repro_torch.core.engine.registry import JobRegistry


def job_history(registry: JobRegistry, metadata=None, *,
                status: Optional[str] = None, user: Optional[str] = None,
                sort_by: str = "job_id", descending: bool = False,
                page: int = 0, page_size: int = 20) -> str:
    """The job-history page: filter -> sort -> paginate -> render."""
    jobs = registry.all_jobs()
    if status:
        jobs = [j for j in jobs if j.state.value == status]
    if user:
        jobs = [j for j in jobs if j.spec.user == user]

    def key(j):
        if sort_by == "runtime":
            return j.runtime or 0.0
        if sort_by == "cost":
            return j.cost or 0.0
        if sort_by == "submitted":
            return j.submitted_at
        return j.job_id
    jobs = sorted(jobs, key=key, reverse=descending)
    total = len(jobs)
    jobs = jobs[page * page_size:(page + 1) * page_size]

    lines = [f"| job | name | user | state | runtime_s | cost | tags |",
             f"|---|---|---|---|---|---|---|"]
    for j in jobs:
        md = metadata.get(j.job_id) if metadata else {}
        tags = ",".join(f"{k}={v}" for k, v in sorted(md.items())
                        if v is not None and k not in
                        ("create_time", "kind", "state", "runtime",
                         "cost", "creator", "project", "model")) or "-"
        rt = f"{j.runtime:.2f}" if j.runtime is not None else "-"
        cost = f"${j.cost:.5f}" if j.cost is not None else "-"
        lines.append(f"| {j.job_id} | {j.spec.name} | {j.spec.user} "
                     f"| {j.state.value} | {rt} | {cost} | {tags} |")
    lines.append(f"\npage {page + 1} of "
                 f"{max(1, (total + page_size - 1) // page_size)} "
                 f"({total} jobs)")
    return "\n".join(lines)


def _pct(u: float) -> str:
    """Render a utilization fraction; an over-committed dimension (a pool
    shrunk below its live reservations reports ``inf``) is flagged
    instead of fed to arithmetic that would print garbage."""
    if u == float("inf"):
        return "OVERCOMMIT"
    return f"{u * 100:.1f}%"


def scheduler_page(scheduler, monitor=None) -> str:
    """The cluster page: per-pool capacity + utilization + placement
    counts (spot pools tagged), per-queue pressure and queue-wait
    statistics from the capacity scheduler."""
    lines = []
    with scheduler._lock:     # dispatch may be running on a worker thread
        pools = getattr(scheduler, "pools", {})
        if pools:
            placed = scheduler.stats.get("placed_by_pool", {})
            lines.append("| pool | resource | capacity | used "
                         "| utilization | placed |")
            lines.append("|---|---|---|---|---|---|")
            for pname in sorted(pools):
                cl = pools[pname]
                util = cl.utilization()
                tag = f"{pname} (spot)" if getattr(cl, "spot", False) \
                    else pname
                for dim in cl.capacity:
                    lines.append(f"| {tag} | {dim} "
                                 f"| {cl.capacity[dim]:g} "
                                 f"| {cl.used[dim]:g} "
                                 f"| {_pct(util[dim])} "
                                 f"| {placed.get(pname, 0)} |")
            health_lines = []
            for pname in sorted(pools):
                health_fn = getattr(pools[pname], "node_health", None)
                h = health_fn() if callable(health_fn) else {}
                if not h.get("nodes"):
                    continue    # no node accounting on this pool
                note = ""
                if h["failed"]:
                    note += f" failed={h['failed']}"
                if h["drained"]:
                    note += f" drained={h['drained']}"
                health_lines.append(
                    f"  {pname}: {h['up']}/{h['nodes']} nodes up{note}")
            if health_lines:
                lines.append("node health:")
                lines.extend(health_lines)
        else:
            lines.append("(no cluster attached — capacity-unconstrained)")

        placement = getattr(scheduler, "placement", None)
        pstats = getattr(placement, "stats", None)
        if pstats and any(pstats.values()):
            # where scored runtimes came from — a high "default" count
            # means placement is ranking on silent 1.0s guesses
            lines.append("prediction sources: " + " ".join(
                f"{k}={pstats[k]}" for k in sorted(pstats)))

        lines.append("")
        lines.append("| queue (project, user) | depth | active | waits | "
                     "mean_wait_s |")
        lines.append("|---|---|---|---|---|")
        keys = sorted(set(scheduler._queues) | set(scheduler._active)
                      | set(scheduler.stats["wait_by_key"]))
        for key in keys:
            count, total = scheduler.stats["wait_by_key"].get(key, (0, 0.0))
            mean_w = total / count if count else 0.0
            # live depth, not raw deque length: launched/killed jobs leave
            # tombstones in the deque until they are compacted away
            depth = scheduler._qlen.get(key, 0)
            active = len(scheduler._active.get(key, ()))
            lines.append(f"| {key} | {depth} | {active} | {count} "
                         f"| {mean_w:.2f} |")
        s = scheduler.stats
        lines.append(f"\nlaunched={s['launched']} "
                     f"completed={s['completed']} "
                     f"backfilled={s['backfilled']} "
                     f"mean_queue_wait={scheduler.mean_queue_wait():.2f}s")
        if s.get("preempted") or s.get("reclaimed") or s.get("drained"):
            lines.append(f"preempted={s['preempted']} "
                         f"spot_reclaimed={s['reclaimed']} "
                         f"shrink_drained={s['drained']}")
        if (s.get("retried") or s.get("quarantined") or s.get("timeouts")
                or s.get("deadline_kills") or s.get("node_failures")):
            lines.append(f"retried={s.get('retried', 0)} "
                         f"quarantined={s.get('quarantined', 0)} "
                         f"timeouts={s.get('timeouts', 0)} "
                         f"deadline_kills={s.get('deadline_kills', 0)} "
                         f"node_failures={s.get('node_failures', 0)} "
                         f"retry_wasted_s={s.get('retry_wasted_s', 0.0):.1f}")
        drift = sum(cl.stats.get("release_underflow", 0)
                    for cl in pools.values() if hasattr(cl, "stats"))
        if drift:
            lines.append(f"release_underflow={drift}  "
                         "(capacity accounting drift — investigate)")
        if s.get("snapshots_skipped"):
            lines.append(f"snapshots={s['snapshots']} "
                         f"coalesced={s['snapshots_skipped']} "
                         f"(interval={scheduler.snapshot_interval:g}s)")
    if monitor is not None:
        # one locked snapshot: peak and mean must come from the same
        # ingest point, not interleave with a concurrent sample
        has_samples, peak, mean = monitor.utilization_summary()
        if has_samples:
            for dim in peak:
                lines.append(f"utilization.{dim}: "
                             f"mean={_pct(mean.get(dim, 0.0))} "
                             f"peak={_pct(peak[dim])}")
    return "\n".join(lines)


def provenance_page(provenance, root: Optional[str] = None,
                    direction: str = "backward", max_depth: int = 10) -> str:
    """The provenance page: whole graph, or interactive trace from a node."""
    if root is None:
        g = provenance.whole_graph()
        lines = [f"{len(g['nodes'])} filesets, {len(g['edges'])} actions"]
        for u, v, d in g["edges"]:
            tag = d.get("job_id", d.get("action", "?"))
            lines.append(f"  {u} --[{tag}]--> {v}")
        return "\n".join(lines)

    step = provenance.backward if direction == "backward" \
        else provenance.forward
    arrow = "<--" if direction == "backward" else "-->"
    lines = [root]
    frontier = [(root, 0)]
    seen = {root}
    while frontier:
        node, depth = frontier.pop()
        if depth >= max_depth:
            continue
        for other, d in step(node):
            tag = d.get("job_id", d.get("action", "?"))
            lines.append("  " * (depth + 1) + f"{arrow}[{tag}] {other}")
            if other not in seen:
                seen.add(other)
                frontier.append((other, depth + 1))
    return "\n".join(lines)
