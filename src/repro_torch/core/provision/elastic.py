"""Elastic pool provisioning (ACAI §3.3.2's loop applied to capacity).

A copy of ``repro/core/provision/elastic.py``, with its imports in
``repro_torch.core``.

The paper's headline (1.7x speed-up, 39 % cost cut) comes from a
provisioning loop that keeps just enough of the right hardware running.
``ElasticController`` is that loop for the engine's capacity pools: it
watches each pool's utilization pressure and queued demand and grows or
shrinks the pool in whole-node steps between ``min_nodes`` and
``max_nodes``, through ``Scheduler.resize_pool`` — so a shrink below live
reservations drains through the same checkpoint-aware preemption path a
spot reclamation uses, and a grow immediately re-dispatches the backlog.
Resizable gangs (``GangSpec.min_pods > 0``) soften those drains: the
scheduler first shrinks running gangs to ``k`` pods (freeing capacity
with no requeue and no lost work) and only preempts whole jobs for
whatever overage remains.

The controller is deliberately clock-agnostic: ``step(now)`` is called by
whoever owns time (the benchmark's virtual-clock loop, a wall-clock
daemon thread, a test). Decisions are recorded with timestamps, which
makes the *provisioned* cost of a run computable (node-hours per pool x
the node's hourly rate) — the number an elastic deployment actually
optimizes, as opposed to the per-job billing that ignores idle capacity.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class PoolPolicy:
    """Scaling knobs for one pool.

    ``node_shape`` is the capacity one node contributes per dimension
    (pool capacity = nodes x shape). ``grow_at``/``shrink_at`` are
    max-dimension utilization thresholds; growth additionally requires
    queued demand for the pool (high utilization with an empty queue is
    a pool doing its job, not pressure), and shrink requires none. An
    over-committed pool (utilization ``inf`` after an external shrink or
    reclaim) counts as pressure. ``cooldown_s`` spaces scale operations
    so one burst cannot thrash the pool.
    """
    node_shape: dict[str, float]
    min_nodes: int = 1
    max_nodes: int = 8
    grow_at: float = 0.85
    shrink_at: float = 0.25
    step_nodes: int = 1
    cooldown_s: float = 120.0


@dataclasses.dataclass
class ScaleDecision:
    at: float
    pool: str
    action: str                 # "grow" | "shrink"
    nodes_before: int
    nodes_after: int
    reason: str


class ElasticController:
    """Grows/shrinks scheduler pools from utilization pressure."""

    def __init__(self, scheduler, policies: dict[str, PoolPolicy]):
        self.scheduler = scheduler
        self.policies = dict(policies)
        self.decisions: list[ScaleDecision] = []
        self._nodes: dict[str, int] = {}
        self._last_op: dict[str, float] = {}
        self._t0 = scheduler._now()
        for pool, pol in self.policies.items():
            cl = scheduler.pools[pool]
            # infer the current node count from capacity / node shape
            # (the max across dims tolerates a partially-shaped pool)
            counts = [cl.capacity.get(d, 0.0) / amt
                      for d, amt in pol.node_shape.items() if amt > 0]
            self._nodes[pool] = max(1, int(round(max(counts, default=1))))

    def nodes(self, pool: str) -> int:
        return self._nodes[pool]

    def _pressure(self, pool: str) -> float:
        """Max-dimension utilization; ``inf`` (over-commit) is pressure."""
        util = self.scheduler.pools[pool].utilization()
        return max(util.values(), default=0.0)

    def step(self, now: Optional[float] = None) -> list[ScaleDecision]:
        """One control round over every managed pool; returns the scale
        decisions taken (possibly empty)."""
        out: list[ScaleDecision] = []
        now = self.scheduler._now() if now is None else now
        for pool, pol in self.policies.items():
            if now - self._last_op.get(pool, float("-inf")) < pol.cooldown_s:
                continue
            util = self._pressure(pool)
            queued = self.scheduler.queued_demand(pool)
            n = self._nodes[pool]
            if util >= pol.grow_at and queued > 0 and n < pol.max_nodes:
                new = min(pol.max_nodes, n + pol.step_nodes)
                action, reason = "grow", f"util={util:.2f} queued={queued}"
            elif util <= pol.shrink_at and queued == 0 and n > pol.min_nodes:
                new = max(pol.min_nodes, n - pol.step_nodes)
                action, reason = "shrink", f"util={util:.2f} idle"
            else:
                continue
            cap = {d: amt * new for d, amt in pol.node_shape.items()}
            self.scheduler.resize_pool(pool, cap)
            self._nodes[pool] = new
            self._last_op[pool] = now
            dec = ScaleDecision(now, pool, action, n, new, reason)
            self.decisions.append(dec)
            out.append(dec)
        return out

    # -- provisioned-cost accounting ------------------------------------
    def node_hours(self, until: float) -> dict[str, float]:
        """Integral of the node count over time per managed pool, from
        controller construction to ``until`` — what the deployment
        actually paid for, idle or not."""
        out: dict[str, float] = {}
        for pool in self.policies:
            t = self._t0
            # reconstruct the initial count from the decision log (the
            # first decision's nodes_before), falling back to current
            decs = [d for d in self.decisions if d.pool == pool]
            n = decs[0].nodes_before if decs else self._nodes[pool]
            total = 0.0
            for d in decs:
                total += n * max(0.0, d.at - t)
                t, n = d.at, d.nodes_after
            total += n * max(0.0, until - t)
            out[pool] = total / 3600.0
        return out

    def provisioned_cost(self, until: float,
                         node_rate: dict[str, float]) -> float:
        """Dollars of provisioned capacity: node-hours x each pool's
        per-node hourly rate (``node_rate[pool]``)."""
        hours = self.node_hours(until)
        return sum(h * node_rate.get(p, 0.0) for p, h in hours.items())
