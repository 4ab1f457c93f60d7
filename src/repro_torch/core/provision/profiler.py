"""Profiler: learning to predict runtime (ACAI §4.2.2–§4.2.3).

A copy of ``repro/core/provision/profiler.py``, with its imports
in ``repro_torch.core``.

The user supplies a command template with hints (sets of values per
argument); the profiler launches |cpus||mems|∏|opts_i| profiling jobs
through the execution engine, waits for a 95 % quorum (straggler policy),
and fits the paper's log-linear model

    log y = log alpha + sum_i beta_i log x_i

by least squares over the explored grid. ``predict`` is the serving
endpoint the auto-provisioner queries.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, Optional

import numpy as np


@dataclasses.dataclass
class CommandTemplate:
    """'python train.py --epoch {1,2,5} ...' + resource exploration sets."""
    name: str
    hints: dict[str, list[float]]             # arg -> candidate values
    resource_hints: dict[str, list[float]]    # resource dim -> explored set

    def grid(self) -> list[dict[str, float]]:
        names = list(self.hints) + list(self.resource_hints)
        spaces = [self.hints[n] for n in self.hints] + \
                 [self.resource_hints[n] for n in self.resource_hints]
        return [dict(zip(names, combo))
                for combo in itertools.product(*spaces)]

    @property
    def feature_names(self) -> list[str]:
        return list(self.hints) + list(self.resource_hints)


class LogLinearModel:
    """y = alpha * prod_i x_i^beta_i, fit in log space (paper §4.2.3).

    With ``clamp=True`` predictions are clamped to the explored grid:
    feature values outside the fitted hull are clipped to it (in log
    space) and the output is bounded to ``[y_min / slack, y_max * slack]``
    of the training runtimes. A log-linear model extrapolates as a power
    law, so a config far off-grid produces unbounded runtimes — fine for
    the auto-provisioner's refine loop (which *measures* the winning
    config and corrects, and whose exact-extrapolation behavior is
    pinned), poison for placement scores served blind. The profiler's
    placement-serving endpoint (``predict_for_pool``) therefore clamps;
    raw ``predict`` keeps the seed's exact extrapolation by default.
    """

    EXTRAPOLATION_SLACK = 8.0     # output bound: [y_min/8, y_max*8]

    def __init__(self, feature_names: list[str], clamp: bool = False):
        self.feature_names = feature_names
        self.clamp = clamp
        self.coef: Optional[np.ndarray] = None    # [log alpha, betas...]
        self._f_lo: Optional[np.ndarray] = None   # per-feature log bounds
        self._f_hi: Optional[np.ndarray] = None
        self._y_lo: float = 0.0                   # runtime bounds (seconds)
        self._y_hi: float = float("inf")

    def _design(self, configs: list[dict[str, float]]) -> np.ndarray:
        X = np.ones((len(configs), 1 + len(self.feature_names)))
        for i, c in enumerate(configs):
            for j, n in enumerate(self.feature_names):
                X[i, 1 + j] = math.log(max(float(c[n]), 1e-12))
        return X

    def fit(self, configs: list[dict[str, float]],
            runtimes: list[float],
            weights: Optional[list[float]] = None) -> "LogLinearModel":
        """Least squares in log space; ``weights`` (optional, one per
        observation) makes it weighted least squares — the online
        feedback path uses recency weights so stale measurements fade."""
        X = self._design(configs)
        y = np.log(np.maximum(np.asarray(runtimes, float), 1e-12))
        if len(configs) > 1:
            self._f_lo = X[:, 1:].min(axis=0)
            self._f_hi = X[:, 1:].max(axis=0)
        slack = self.EXTRAPOLATION_SLACK
        self._y_lo = float(min(runtimes)) / slack
        self._y_hi = float(max(runtimes)) * slack
        if weights is not None:
            w = np.sqrt(np.maximum(np.asarray(weights, float), 1e-12))
            X = X * w[:, None]
            y = y * w
        self.coef, *_ = np.linalg.lstsq(X, y, rcond=None)
        return self

    def in_hull(self, config: dict[str, float],
                slack: float = 2.0) -> bool:
        """Whether ``config`` sits within the explored feature hull
        (each feature inside ``[lo / slack, hi * slack]``). A model fit
        from fewer than two configs has no hull and never contains
        anything — one point is not support. Callers use this to decide
        when a fitted model's (clamped) extrapolation is still more
        trustworthy than an analytic prior."""
        if self._f_lo is None:
            return False
        x = self._design([config])[0, 1:]
        pad = math.log(max(slack, 1.0))
        return bool(np.all(x >= self._f_lo - pad)
                    and np.all(x <= self._f_hi + pad))

    def _predict_design(self, configs: list[dict[str, float]],
                        clamp: bool) -> np.ndarray:
        X = self._design(configs)
        if clamp and self._f_lo is not None:
            X[:, 1:] = np.clip(X[:, 1:], self._f_lo, self._f_hi)
        return X

    def predict(self, config: dict[str, float],
                clamp: Optional[bool] = None) -> float:
        if self.coef is None:
            raise RuntimeError(
                f"LogLinearModel({self.feature_names}): predict before fit")
        clamp = self.clamp if clamp is None else clamp
        y = float(np.exp(self._predict_design([config], clamp)
                         @ self.coef)[0])
        if clamp:
            y = min(max(y, self._y_lo), self._y_hi)
        return y

    def predict_many(self, configs: list[dict[str, float]],
                     clamp: Optional[bool] = None) -> np.ndarray:
        if self.coef is None:
            raise RuntimeError(
                f"LogLinearModel({self.feature_names}): predict before fit")
        clamp = self.clamp if clamp is None else clamp
        y = np.exp(self._predict_design(configs, clamp) @ self.coef)
        if clamp:
            y = np.clip(y, self._y_lo, self._y_hi)
        return y

    # -- evaluation metrics (paper Table 1) -----------------------------
    @staticmethod
    def errors(pred: np.ndarray, true: np.ndarray) -> dict[str, float]:
        pred, true = np.asarray(pred, float), np.asarray(true, float)
        l1 = float(np.abs(pred - true).mean())
        l2 = float(((pred - true) ** 2).mean())
        var = float(((true - true.mean()) ** 2).mean())
        return {"l1": l1, "l2": l2,
                "variance_explained": 1.0 - l2 / max(var, 1e-12)}


class Profiler:
    """Drives profiling fleets through the engine and serves predictions.

    ``prior`` (a ``roofline.prior.RooflinePrior``, or any object with its
    interface) supplies analytical cold-start estimates: ``predict_for_pool`` serves the
    prior whenever no fitted model exists for the template, so placement
    on a cold cluster scores real physics instead of ``1.0``-second
    defaults. ``recency_halflife`` (observation count) makes online
    refits recency-weighted: an observation ``k`` runs old carries
    weight ``0.5 ** (k / halflife)``, so drifting pools re-learn instead
    of averaging stale history forever. ``window`` caps each template's
    retained observations (oldest dropped) to bound refit cost.
    """

    def __init__(self, engine, quorum: float = 0.95, priority: int = 0,
                 prior=None, recency_halflife: Optional[float] = None,
                 window: int = 512):
        # engine: repro_torch.core.acai.AcaiEngine (registry+scheduler
        # facade)
        # priority: scheduling priority stamped on profiling jobs — the
        # fleets are small and short, ideal backfill candidates, so
        # platforms typically submit them below training priority.
        self.engine = engine
        self.quorum = quorum
        self.priority = priority
        self.prior = prior
        self.recency_halflife = recency_halflife
        self.window = window
        self.models: dict[str, LogLinearModel] = {}
        self.training_sets: dict[str, tuple[list[dict], list[float]]] = {}
        # where the last predict_for_pool answer came from:
        # "pool-model" | "model" | "prior" (placement surfaces this
        # in its fallback stats)
        self.last_source: Optional[str] = None

    def profile(self, template: CommandTemplate,
                job_factory: Callable[[dict[str, float]], "Any"],
                ) -> LogLinearModel:
        """job_factory(config) -> JobSpec for one profiling run."""
        grid = template.grid()
        specs = [job_factory(cfg) for cfg in grid]
        for spec in specs:
            if not spec.priority:
                spec.priority = self.priority
        jobs = [self.engine.submit(spec) for spec in specs]
        res = self.engine.scheduler.run_until_quorum(
            [j.job_id for j in jobs], frac=self.quorum)
        configs, runtimes = [], []
        for cfg, job in zip(grid, jobs):
            j = self.engine.registry.get(job.job_id)
            if j.state.value == "FINISHED" and j.runtime is not None:
                configs.append(cfg)
                runtimes.append(j.runtime)
        model = LogLinearModel(template.feature_names).fit(configs, runtimes)
        self.models[template.name] = model
        self.training_sets[template.name] = (configs, runtimes)
        return model

    def fit_offline(self, template: CommandTemplate,
                    configs: list[dict[str, float]],
                    runtimes: list[float]) -> LogLinearModel:
        """Fit directly from measured (config, runtime) pairs — used by the
        CPU-measured reproduction bench and by compile-based oracles."""
        model = LogLinearModel(template.feature_names).fit(configs, runtimes)
        self.models[template.name] = model
        self.training_sets[template.name] = (configs, runtimes)
        return model

    def add_observation(self, template_name: str, config: dict[str, float],
                        runtime: float) -> None:
        """Active refinement: fold one new measured run into the model.

        A template never seen before bootstraps a fresh training set
        (features = the observation's numeric keys) — this is how the
        launcher feedback loop grows per-pool models on a cold cluster.
        The refit is recency-weighted when ``recency_halflife`` is set
        and the retained history is capped at ``window`` observations.
        """
        if template_name not in self.training_sets:
            self.training_sets[template_name] = ([], [])
        configs, runtimes = self.training_sets[template_name]
        configs.append(dict(config))
        runtimes.append(float(runtime))
        if self.window and len(configs) > self.window:
            del configs[:len(configs) - self.window]
            del runtimes[:len(runtimes) - self.window]
        if template_name in self.models:
            features = self.models[template_name].feature_names
        else:
            features = sorted(k for k, v in config.items()
                              if isinstance(v, (int, float)))
        weights = None
        if self.recency_halflife:
            n = len(runtimes)
            weights = [0.5 ** ((n - 1 - i) / self.recency_halflife)
                       for i in range(n)]
        self.models[template_name] = LogLinearModel(features).fit(
            configs, runtimes, weights)

    # the "endpoint for querying the runtime of a command template"
    def predict(self, template_name: str, config: dict[str, float]) -> float:
        return self.models[template_name].predict(config)

    def has_model(self, template_name: str) -> bool:
        return template_name in self.models

    # -- heterogeneous pools ---------------------------------------------
    # Per-family runtime models are plain templates named
    # "<template>@<pool>" (fit them with profile()/fit_offline() on that
    # pool's resource dims); placement and the auto-provisioner fall back
    # to the family-agnostic model when a pool was never profiled.
    @staticmethod
    def pool_template(template_name: str, pool: str) -> str:
        return f"{template_name}@{pool}"

    def resolve_source(self, template_name: str, pool: str,
                       config: Optional[dict] = None) -> Optional[str]:
        """Which estimator ``predict_for_pool`` would serve from:
        ``"pool-model"`` (fitted ``<tmpl>@<pool>``), ``"model"``
        (family-agnostic fit), ``"prior"`` (roofline cold-start), or
        None (no estimate — placement falls back to declared duration).
        A fitted model beats the prior *inside its measured support*:
        with ``config`` given, a model whose explored hull does not
        contain the config defers to the prior (when one can estimate) —
        a model fit on 30-second profiling runs has nothing trustworthy
        to say about an hour-long training job, while the roofline
        arithmetic extrapolates by construction."""
        prior_ok = self.prior is not None and \
            self.prior.can_estimate(template_name, pool)

        def trusted(name: str) -> bool:
            if config is None or not prior_ok:
                return True
            return self.models[name].in_hull(config)
        pool_name = self.pool_template(template_name, pool)
        if pool_name in self.models and trusted(pool_name):
            return "pool-model"
        if template_name in self.models and trusted(template_name):
            return "model"
        if prior_ok:
            return "prior"
        # an out-of-hull model with no prior still serves (clamped):
        # a bounded estimate beats the silent 1.0-second default
        if pool_name in self.models:
            return "pool-model"
        if template_name in self.models:
            return "model"
        return None

    def predict_for_pool(self, template_name: str, pool: str,
                         config: dict[str, float]) -> float:
        """Per-pool prediction with fitted-model > prior precedence
        (within the model's explored hull — see ``resolve_source``);
        raises (KeyError) when neither exists, which placement's
        predictor wrapper treats as 'no prediction'."""
        src = self.resolve_source(template_name, pool, config)
        self.last_source = src
        if src == "pool-model":
            return self.models[self.pool_template(
                template_name, pool)].predict(config, clamp=True)
        if src == "model":
            return self.models[template_name].predict(config, clamp=True)
        if src == "prior":
            return self.prior.estimate(template_name, pool, config)
        raise KeyError(template_name)

    # -- online feedback (the launcher -> profiler leg of the loop) ------
    def observe(self, job) -> bool:
        """Fold one finished job's measured runtime into the per-pool
        model keyed ``"<template>@<pool>"``. The observation config is
        the job's numeric args + its pinned resource shape — exactly the
        config placement predicts with, so the refit corrects the very
        estimate that placed the job. Returns False (no-op) for jobs
        with no template/pool/runtime."""
        spec = job.spec
        pool = getattr(job, "pool", None)
        if not getattr(spec, "template", None) or not pool \
                or job.runtime is None:
            return False
        cfg = {k: float(v) for k, v in (spec.args or {}).items()
               if isinstance(v, (int, float))}
        cfg.update(spec.resources or {})
        self.add_observation(self.pool_template(spec.template, pool),
                             cfg, job.runtime)
        return True

    def attach_feedback(self, bus, registry) -> None:
        """Subscribe to the launcher's terminal events: every FINISHED
        job's actual runtime feeds :meth:`observe`. Strictly opt-in —
        nothing in the engine behaves differently until a caller
        attaches the loop (golden decision traces stay bit-identical
        with it detached)."""
        from repro_torch.core.engine.events import TOPIC_CONTAINER_STATUS

        def _on_status(msg: dict) -> None:
            if msg.get("status") != "FINISHED":
                return
            try:
                job = registry.get(msg["job_id"])
            except KeyError:
                return
            try:
                self.observe(job)
            except Exception:  # noqa: BLE001 — feedback must never kill
                pass           # the launcher's publish path
        bus.subscribe(TOPIC_CONTAINER_STATUS, _on_status)
