"""Roofline cold-start priors: analytical runtime estimates for placement.

A copy of ``repro/roofline/prior.py`` with two differences. It holds no TPU
constant: its hardware is the NVIDIA H100 (``H100``), whose constants
``roofline/analysis.py`` reads from here. And its cost source is a count,
not HLO text: ``TemplateCost.from_count`` and
``RooflinePrior.register_count`` take an ``op_cost.Cost`` (a step counted
op by op, on fake tensors by ``launch/dryrun.py``) where the reference's
``from_hlo`` and ``register_hlo`` parse a compiled XLA module, which the
port does not produce; those two raise.

The profiler's log-linear models need measured runs to exist; a cold
cluster has none, and placement would default every unknown template to
``duration or 1.0``. This module derives a *prior* runtime estimate from
roofline arithmetic: a template registers an analytic cost (FLOPs, device
memory bytes and collective bytes as functions of the job config), each
accelerator family registers its hardware constants, and the estimate is

    t = startup + max(flops / (peak * n), bytes / (hbm_bw * n),
                      coll_bytes / ici_bw)

with ``n`` the config's device count on families whose compute scales with
a resource dimension. ``Profiler(prior=...)`` serves these from
``predict_for_pool`` whenever no fitted model exists, and online
``add_observation`` feedback replaces the prior with a measured per-pool
model as soon as real runtimes arrive.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

CostFn = Union[float, Callable[[dict], float]]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """One accelerator family's roofline constants.

    ``scale_dim`` names the resource dimension whose amount multiplies
    aggregate compute/bandwidth (e.g. ``"chips"``); ``ref_chips`` is the
    amount the registered cost models are normalized to (cost models give
    *total* work, so ``n = config[scale_dim] / ref_chips`` divides it across
    the devices). ``ici_bw`` is the rate at which a device's collective
    bytes leave it; 0 counts no collective term (one device). ``startup_s``
    is the per-job provisioning tax the roofline terms sit on top of.
    """
    family: str
    peak_flops: float
    hbm_bw: float
    ici_bw: float = 0.0
    startup_s: float = 0.0
    scale_dim: Optional[str] = None
    ref_chips: float = 1.0

    def chips(self, config: dict) -> float:
        if self.scale_dim is None:
            return 1.0
        return max(float(config.get(self.scale_dim, self.ref_chips))
                   / self.ref_chips, 1e-9)


# NVIDIA H100 SXM 80GB HBM3 (NVIDIA's data sheet, at the full 700 W power
# limit): 989 TFLOP/s dense bf16 on the tensor cores and 3.35 TB/s of HBM3,
# the rates chip_smoke.py's bounds use; NVLink 4 carries 900 GB/s a card,
# both directions together, so a device's collective bytes leave it at
# 450 GB/s.
H100 = HardwareSpec("h100", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
                    scale_dim="chips", ref_chips=1.0)


def roofline_ceiling_s(flops: float, nbytes: float,
                       hw: HardwareSpec, coll_bytes: float = 0.0,
                       n_chips: float = 1.0) -> float:
    """Best-case seconds for a workload on ``hw``: the roofline max of
    the compute / memory / interconnect terms (no startup)."""
    n = max(n_chips, 1e-9)
    return max(flops / (hw.peak_flops * n),
               nbytes / (hw.hbm_bw * n),
               coll_bytes / hw.ici_bw if hw.ici_bw else 0.0)


def _no_hlo(what: str):
    raise NotImplementedError(
        f"{what} parses XLA HLO text, which the port does not produce. Its "
        "counterpart reads a dispatch-mode count of the step (ROADMAP "
        "A11b.4: roofline.op_cost.count, launch.dryrun.run_cell): use "
        "TemplateCost.from_count or RooflinePrior.register_count, or "
        "register an analytic cost with RooflinePrior.register.")


def _scale(scale_by: Optional[str]) -> Callable[[dict], float]:
    if scale_by is None:
        return lambda cfg: 1.0
    return lambda cfg: max(float(cfg.get(scale_by, 1.0)), 0.0)


@dataclasses.dataclass
class TemplateCost:
    """Analytic cost of one command template as functions of the job
    config (numeric args + resource shape, the same dict placement
    feeds ``predict_for_pool``). Constants are accepted where the cost
    does not depend on the config."""
    flops: CostFn = 0.0
    nbytes: CostFn = 0.0
    coll_bytes: CostFn = 0.0

    @staticmethod
    def _eval(fn: CostFn, config: dict) -> float:
        return float(fn(config)) if callable(fn) else float(fn)

    def evaluate(self, config: dict) -> tuple[float, float, float]:
        return (self._eval(self.flops, config),
                self._eval(self.nbytes, config),
                self._eval(self.coll_bytes, config))

    @classmethod
    def from_count(cls, cost, *,
                   scale_by: Optional[str] = None) -> "TemplateCost":
        """The FLOPs, memory-term bytes and collective bytes of a counted
        step (an ``op_cost.Cost``: ``flops``, ``bytes``, the term that
        ``analysis`` reads on the port, and ``coll_bytes``), the
        counterpart of the reference's ``from_hlo``. ``scale_by``
        optionally names a config key that multiplies the cost (e.g.
        steps or tokens per job)."""
        scale = _scale(scale_by)
        flops, nbytes, coll = (float(cost.flops), float(cost.bytes),
                               float(cost.coll_bytes))
        return cls(flops=lambda cfg: flops * scale(cfg),
                   nbytes=lambda cfg: nbytes * scale(cfg),
                   coll_bytes=lambda cfg: coll * scale(cfg))

    @classmethod
    def from_hlo(cls, hlo_text: str, *,
                 scale_by: Optional[str] = None) -> "TemplateCost":
        """Not in the port: raises NotImplementedError; see
        ``from_count``."""
        _no_hlo("TemplateCost.from_hlo")


class RooflinePrior:
    """Cold-start runtime estimates per (template, accelerator family).

    ``hardware`` maps pool/family name -> :class:`HardwareSpec`;
    templates register analytic costs with :meth:`register`.
    :meth:`estimate` raises ``KeyError`` for an unknown template or family
    so callers (``Profiler.predict_for_pool``) can fall through to their
    own defaults.
    """

    def __init__(self, hardware: dict[str, HardwareSpec]):
        self.hardware = dict(hardware)
        self.templates: dict[str, TemplateCost] = {}

    def register(self, template: str, *, flops: CostFn = 0.0,
                 nbytes: CostFn = 0.0,
                 coll_bytes: CostFn = 0.0) -> "RooflinePrior":
        self.templates[template] = TemplateCost(flops, nbytes, coll_bytes)
        return self

    def register_count(self, template: str, cost, *,
                       scale_by: Optional[str] = None) -> "RooflinePrior":
        """``template``'s cost from a counted step
        (``TemplateCost.from_count``), the counterpart of the reference's
        ``register_hlo``."""
        self.templates[template] = TemplateCost.from_count(
            cost, scale_by=scale_by)
        return self

    def register_hlo(self, template: str, hlo_text: str, *,
                     scale_by: Optional[str] = None) -> "RooflinePrior":
        """Not in the port: raises NotImplementedError; see
        ``register_count``."""
        _no_hlo("RooflinePrior.register_hlo")

    def can_estimate(self, template: str, family: str) -> bool:
        return template in self.templates and family in self.hardware

    def estimate(self, template: str, family: str, config: dict) -> float:
        """Prior runtime seconds; KeyError when template/family unknown."""
        tc = self.templates[template]
        hw = self.hardware[family]
        flops, nbytes, coll = tc.evaluate(config)
        return hw.startup_s + roofline_ceiling_s(
            flops, nbytes, hw, coll_bytes=coll, n_chips=hw.chips(config))
