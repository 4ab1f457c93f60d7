"""Auto-provisioner (ACAI §3.3.2, §4.2.4): constrained grid search over the
discrete resource space using the profiler's predictions.

A copy of ``repro/core/provision/autoprovision.py``, with its imports
in ``repro_torch.core``.

Two tasks, exactly as the paper:
  optimize runtime  s.t. predicted cost    <= max_cost
  optimize cost     s.t. predicted runtime <= max_runtime

With a pricing *catalog* (``{pool_name: Pricing}``, one per accelerator
family) the search spans every pool's grid: each candidate is a
(pool, resources) pair, runtimes come from the pool's model
(``"<template>@<pool>"`` when profiled, the family-agnostic template
otherwise), and the decision records which pool won — the provisioning
half of the placement layer's cost/speed frontier.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

from repro_torch.core.provision.pricing import Pricing
from repro_torch.core.provision.profiler import Profiler


@dataclasses.dataclass
class ProvisionDecision:
    resources: dict[str, float]
    predicted_runtime: float
    predicted_cost: float
    # full search table for Fig.16-style visualization / audits
    table: list[dict[str, Any]]
    objective: str
    pool: str = "default"           # the accelerator family that won

    @property
    def feasible(self) -> bool:
        return bool(self.resources)


class AutoProvisioner:
    def __init__(self, profiler: Profiler,
                 pricing: Union[Pricing, dict[str, Pricing]]):
        self.profiler = profiler
        self.pricing = pricing      # as given (legacy callers read it)
        self.catalog: dict[str, Pricing] = \
            pricing if isinstance(pricing, dict) else {"default": pricing}

    def _template_for(self, template_name: str, pool: str) -> str:
        """The pool's own profiled model when one exists, else the
        family-agnostic template."""
        if pool != "default":
            cand = Profiler.pool_template(template_name, pool)
            if getattr(self.profiler, "has_model", lambda n: False)(cand):
                return cand
        return template_name

    def _search(self, template_name: str, values: dict[str, float],
                *, max_cost: Optional[float], max_runtime: Optional[float],
                objective: str) -> ProvisionDecision:
        table = []
        best = None
        for pool, pricing in self.catalog.items():
            tname = self._template_for(template_name, pool)
            for resources in pricing.grid():
                cfg = dict(values)
                cfg.update(resources)
                t = self.profiler.predict(tname, cfg)
                c = pricing.job_cost(resources, t)
                ok = ((max_cost is None or c <= max_cost)
                      and (max_runtime is None or t <= max_runtime))
                table.append({**resources, "pool": pool, "runtime": t,
                              "cost": c, "feasible": ok})
                if not ok:
                    continue
                key = t if objective == "runtime" else c
                if best is None or key < best[0]:
                    best = (key, pool, resources, t, c)
        if best is None:
            return ProvisionDecision({}, float("nan"), float("nan"),
                                     table, objective)
        _, pool, resources, t, c = best
        return ProvisionDecision(dict(resources), t, c, table, objective,
                                 pool=pool)

    def optimize_runtime(self, template_name: str,
                         values: dict[str, float],
                         max_cost: float) -> ProvisionDecision:
        return self._search(template_name, values, max_cost=max_cost,
                            max_runtime=None, objective="runtime")

    def optimize_cost(self, template_name: str, values: dict[str, float],
                      max_runtime: float) -> ProvisionDecision:
        return self._search(template_name, values, max_cost=None,
                            max_runtime=max_runtime, objective="cost")

    # -- beyond-paper: active refinement ---------------------------------
    def refined_search(self, template_name: str, values: dict[str, float],
                       *, measure_fn, objective: str = "runtime",
                       max_cost: Optional[float] = None,
                       max_runtime: Optional[float] = None,
                       rounds: int = 3, tol: float = 0.10) -> tuple[
                           ProvisionDecision, list[dict]]:
        """Search -> measure the winning config with ONE real profiling run
        -> if the prediction was off by > tol, add the observation, refit,
        re-search. Fixes the paper's extrapolation failure (its §5.1 Fig.15
        non-linearity: the model is trusted far outside the profiled hull
        — on pods that's the collective wall) at the cost of <= ``rounds``
        extra profiling jobs. Returns (decision, refinement_history)."""
        history = []
        dec = self._search(template_name, values, max_cost=max_cost,
                           max_runtime=max_runtime, objective=objective)
        for _ in range(rounds):
            if not dec.feasible:
                break
            cfg = dict(values)
            cfg.update(dec.resources)
            true_t = measure_fn(cfg)
            err = abs(dec.predicted_runtime - true_t) / max(true_t, 1e-9)
            history.append({"resources": dict(dec.resources),
                            "predicted_runtime": dec.predicted_runtime,
                            "measured_runtime": true_t, "rel_err": err})
            if err <= tol:
                break
            self.profiler.add_observation(template_name, cfg, true_t)
            dec = self._search(template_name, values, max_cost=max_cost,
                               max_runtime=max_runtime, objective=objective)
        return dec, history
