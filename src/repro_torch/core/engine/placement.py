"""Placement layer: heterogeneous cluster pools (ACAI §4.2 scaled out).

A copy of ``repro/core/engine/placement.py``, with its imports
in ``repro_torch.core``.

The paper's auto-provisioner earns its speedup/cost-saving by choosing
*where* a job runs; this module is the engine-side half of that choice.
A deployment holds one ``Cluster`` pool per accelerator family (CPU node
shapes vs TPU pod slices, each with its own pricing catalog), and
``Placement`` scores each job's eligible pools on the profiler's
cost/speed frontier plus dataflow locality:

  eligibility  — the pool can ever fit the job's resource shape for that
                 pool (``JobSpec.pool_resources`` declares per-family
                 alternatives; a plain ``resources`` dict is tried on
                 every pool, where unknown dimensions reject).
  score        — expected runtime (profiler prediction when available,
                 else the declared duration) x the pool's price =
                 predicted cost; ``objective`` selects cost, runtime, or
                 their product ("balanced" — the cost/speed frontier
                 scalarized).
  locality     — pools already holding a parent stage's output filesets
                 (the pools the parents ran on) get their score
                 discounted, co-placing pipeline stages with their
                 inputs instead of paying a cross-pool transfer.
  spot risk    — a spot pool (``Cluster.spot``) has its score inflated by
                 the reclamations the job is expected to suffer there
                 (``reclaim_rate`` x predicted runtime x
                 ``spot_risk_weight``): short jobs harvest the spot
                 discount, long jobs stay on-demand unless the discount
                 covers the expected lost work + requeues.

The scheduler calls ``eligible`` once per job at submit (failing fast
when no pool can ever satisfy it) and ``rank`` when the job becomes
dispatchable — after dependency release, so every parent's pool is
known. Ties break deterministically on (score, runtime, pool name).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.core.engine.cluster import Cluster


@dataclasses.dataclass
class PoolOption:
    """One pool a job may run on, with the shape/charge/score it would get.

    For a gang, ``resources`` is the shape of ONE pod and ``charge`` the
    *aggregate* (``pods`` x per-pod charge) — the unit the scheduler's
    admission, certificates and shadow math account in, so a gang is
    admitted whole or not at all.
    """
    pool: str
    resources: dict[str, float]
    charge: dict[str, float]
    runtime: Optional[float] = None     # predicted seconds (None = unknown)
    cost: Optional[float] = None        # predicted $ for the whole run
    score: float = 0.0
    local: bool = False                 # a parent stage ran on this pool
    pods: int = 1                       # gang width (1 = ordinary job)


# predictor(spec, pool_name, resources) -> expected runtime seconds | None
Predictor = Callable[[Any, str, dict[str, float]], Optional[float]]


@dataclasses.dataclass
class TransferCostModel:
    """Explicit cross-pool data-movement pricing (replaces the flat
    locality discount when attached to a ``Placement``).

    ``cost_per_gb`` prices moving a parent stage's fileset bytes between
    accelerator families (``pair_cost_per_gb[(src, dst)]`` overrides per
    ordered pair); the cheapest parent pool is charged when a child lands
    off-pool. ``interconnect_weight`` scales the intra-gang penalty for a
    pool that cannot host all of a close-topology gang's pods on one
    interconnect island (``Cluster.close_gang_pods``): the score is
    inflated proportionally to the fraction of pods forced off-island,
    modelling the all-reduce slowdown of a spread data-parallel mesh.
    """
    cost_per_gb: float = 0.0
    pair_cost_per_gb: dict[tuple[str, str], float] = \
        dataclasses.field(default_factory=dict)
    interconnect_weight: float = 1.0

    def transfer_cost(self, src: str, dst: str, nbytes: float) -> float:
        if src == dst or nbytes <= 0:
            return 0.0
        rate = self.pair_cost_per_gb.get((src, dst), self.cost_per_gb)
        return rate * nbytes / 1e9

    def cheapest_transfer(self, parent_pools, dst: str,
                          nbytes: float) -> float:
        """A child with several parents streams from the cheapest one."""
        costs = [self.transfer_cost(src, dst, nbytes)
                 for src in parent_pools]
        return min(costs) if costs else 0.0

    def spread_fraction(self, spec, cluster) -> float:
        """Fraction of a close-topology gang's pods this pool would host
        off-island (0.0 when the gang fits close or topology is 'any')."""
        gang = getattr(spec, "gang", None)
        if gang is None or gang.topology != "close":
            return 0.0
        close = getattr(cluster, "close_gang_pods", None)
        if close is None or close >= gang.n_pods:
            return 0.0
        return (gang.n_pods - close) / gang.n_pods


class Placement:
    """Scores each job's eligible pools; lower score wins.

    ``pools`` maps pool name -> Cluster; ``pricing`` (optional) maps pool
    name -> Pricing so scores are dollars instead of normalized
    resource-time. ``predictor`` supplies expected runtimes — typically
    the profiler, attached via :meth:`use_profiler`.
    """

    def __init__(self, pools: dict[str, Cluster], *,
                 pricing: Optional[dict[str, Any]] = None,
                 predictor: Optional[Predictor] = None,
                 objective: str = "cost",
                 locality_discount: float = 0.75,
                 spot_risk_weight: float = 1.0,
                 transfer_costs: Optional[TransferCostModel] = None):
        if objective not in ("cost", "runtime", "balanced"):
            raise ValueError(f"unknown objective {objective!r}")
        self.pools = dict(pools)
        self.pricing = dict(pricing or {})
        self.predictor = predictor
        self.objective = objective
        self.locality_discount = locality_discount
        # explicit data-movement pricing: when set, it REPLACES the flat
        # locality discount (off-pool children pay the modelled transfer,
        # close-topology gangs pay the interconnect spread penalty); when
        # None the legacy discount path runs, bit-identically
        self.transfer_costs = transfer_costs
        # spot risk pricing: a spot pool's score is inflated by the
        # reclamations the job is expected to suffer there — long jobs
        # lose more to a reclaim (up to a checkpoint interval each, plus
        # the requeue), so the discount has to *earn* the risk
        self.spot_risk_weight = spot_risk_weight
        # where each scored runtime came from, per _score_one call:
        # "predictor" (fitted model / custom predictor), "prior"
        # (roofline cold-start estimate), "declared" (spec.duration),
        # "default" (the silent 1.0s fallback — the number this counter
        # exists to make visible). Dashboard renders these.
        self.stats: dict[str, int] = {"predictor": 0, "prior": 0,
                                      "declared": 0, "default": 0}
        self._pred_source = "predictor"

    # -- eligibility -----------------------------------------------------
    def resources_for(self, spec, pool: str) -> Optional[dict[str, float]]:
        """The resource shape the job would get on ``pool``: its declared
        per-pool alternative, or the generic ``resources`` dict when no
        per-pool menu was declared. None = the job did not declare a shape
        for this pool (an explicit menu is authoritative)."""
        if spec.pool_resources:
            return spec.pool_resources.get(pool)
        return spec.resources

    def eligible(self, spec) -> dict[str, PoolOption]:
        """Pools that could ever run this job (empty => fail fast).

        A gang's option carries the per-pod shape but the *aggregate*
        charge (n_pods x per-pod) — downstream admission/certificate/
        shadow accounting then treats the gang as one unit for free. On a
        node-shaped pool a pod that exceeds the node shape can never pack,
        so the pool is ineligible even when the aggregate would fit."""
        gang = getattr(spec, "gang", None)
        out: dict[str, PoolOption] = {}
        for name, cl in self.pools.items():
            if spec.pool and spec.pool != name:
                continue                      # pinned to another pool
            res = self.resources_for(spec, name)
            if res is None:
                continue
            if gang is not None and gang.per_pod_resources is not None:
                res = gang.per_pod_resources
            charge = cl.charge(res)
            if gang is not None:
                agg = {n: amt * gang.n_pods for n, amt in charge.items()}
                if not cl.ever_fits_charge(agg):
                    continue
                shape = getattr(cl, "node_shape", None)
                if shape is not None and any(
                        amt > shape.get(n, 0.0) + 1e-9
                        for n, amt in charge.items() if amt > 0):
                    continue                  # one pod overflows a node
                out[name] = PoolOption(name, dict(res or {}), agg,
                                       pods=gang.n_pods)
            elif cl.ever_fits_charge(charge):
                out[name] = PoolOption(name, dict(res or {}), charge)
        return out

    # -- scoring ---------------------------------------------------------
    def use_profiler(self, profiler) -> None:
        """Feed the auto-provisioner's profiler into scoring.

        ``spec.template`` names the profiled command template; the
        profiler's ``predict_for_pool`` resolves the per-pool model
        (``"<template>@<pool>"``) with fallback to the family-agnostic
        one. The prediction config is the job's numeric args plus the
        pool's resource shape, matching what the profiler's grids
        explore. Missing models / failed predictions degrade to None
        (placement falls back to declared durations) rather than making
        the job ineligible."""
        def predict(spec, pool: str,
                    resources: dict[str, float]) -> Optional[float]:
            if not spec.template:
                return None
            cfg = {k: v for k, v in (spec.args or {}).items()
                   if isinstance(v, (int, float))}
            cfg.update(resources or {})
            try:
                val = profiler.predict_for_pool(spec.template, pool, cfg)
            except Exception:              # noqa: BLE001 — stay eligible
                return None
            if getattr(profiler, "last_source", None) == "prior":
                self._pred_source = "prior"
            return val
        self.predictor = predict

    def _score_one(self, spec, opt: PoolOption,
                   parent_pools: set[str]) -> None:
        runtime = None
        if self.predictor is not None:
            self._pred_source = "predictor"
            runtime = self.predictor(spec, opt.pool, opt.resources)
        if runtime is None:
            source = "declared" if spec.duration is not None else "default"
            runtime = spec.duration if spec.duration is not None else 1.0
        else:
            source = self._pred_source
        self.stats[source] = self.stats.get(source, 0) + 1
        pricing = self.pricing.get(opt.pool)
        if pricing is not None:
            cost = pricing.job_cost(opt.resources, runtime) * opt.pods
        else:
            # no price catalog: dollars degrade to normalized resource-time
            cl = self.pools[opt.pool]
            cost = runtime * sum(
                amt / cl.capacity[n] for n, amt in opt.charge.items()
                if cl.capacity.get(n, 0.0) > 0)
        opt.runtime, opt.cost = runtime, cost
        score = {"cost": cost, "runtime": runtime,
                 "balanced": cost * runtime}[self.objective]
        opt.local = opt.pool in parent_pools
        cl = self.pools[opt.pool]
        if self.transfer_costs is not None:
            # explicit data movement: an off-pool child pays to move its
            # input bytes from the cheapest parent pool; a close-topology
            # gang pays for every pod the pool forces off-island
            if parent_pools and not opt.local:
                score += self.transfer_costs.cheapest_transfer(
                    parent_pools, opt.pool,
                    getattr(spec, "input_bytes", 0.0))
            frac = self.transfer_costs.spread_fraction(spec, cl)
            if frac > 0.0:
                score *= 1.0 + self.transfer_costs.interconnect_weight * frac
        elif opt.local and len(self.pools) > 1:
            score *= self.locality_discount
        if getattr(cl, "spot", False):
            # expected reclamations over the run × risk weight: a spot
            # pool must be cheap enough to beat on-demand *after* paying
            # for the work a reclaim loses and the requeue it forces
            score *= 1.0 + self.spot_risk_weight * \
                getattr(cl, "reclaim_rate", 0.0) * runtime
        opt.score = score

    def rank(self, spec, options: dict[str, PoolOption],
             parent_pools: set[str] = frozenset()) -> list[str]:
        """Pool names ordered best-first (lowest score)."""
        if len(options) == 1:
            # a single eligible pool ranks as itself: skip the predictor
            # and pricing walk entirely (the homogeneous-deployment hot
            # path — every submit ranks, so this is per-job overhead)
            return list(options)
        for opt in options.values():
            self._score_one(spec, opt, parent_pools)
        return sorted(options, key=lambda p: (options[p].score,
                                              options[p].runtime, p))

    # -- diagnostics -----------------------------------------------------
    def explain_infeasible(self, spec) -> str:
        """Why no pool can run this job — surfaced in the submit error."""
        parts = []
        for name, cl in self.pools.items():
            if spec.pool and spec.pool != name:
                parts.append(f"{name}: pinned to {spec.pool!r}")
                continue
            res = self.resources_for(spec, name)
            if res is None:
                parts.append(f"{name}: no resource shape declared")
                continue
            charge = cl.charge(res)
            bad = [f"{n}={charge[n]:g}>" +
                   (f"{cl.capacity[n]:g}" if n in cl.capacity
                    else "absent")
                   for n in charge
                   if charge[n] > cl.capacity.get(n, 0.0) + 1e-9]
            parts.append(f"{name}: {', '.join(bad) or 'ok'}")
        if spec.pool and spec.pool not in self.pools:
            parts.append(f"(pool {spec.pool!r} does not exist)")
        return "; ".join(parts)
