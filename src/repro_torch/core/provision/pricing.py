"""Cloud pricing model (ACAI §4.3, Fig. 11).

A copy of ``repro/core/provision/pricing.py``, with its imports
in ``repro_torch.core``.

The paper bills each resource dimension separately with a unit price that
RISES LINEARLY with the amount provisioned: 2/3 of the GCP baseline at the
minimum allocation up to 4/3 at the maximum (discourages vertical scaling).

Two concrete pricings ship:
  CPU_PRICING — the paper's original space: 0.5–8 vCPU (step .5),
                512–8192 MB (step 256); GCP N1 us-east1 baselines.
  TPU_PRICING — the TPU-pod adaptation: chips 8–512 (powers of two) and
                per-chip HBM GB; v5e-class on-demand baseline.

A heterogeneous deployment holds one catalog entry per accelerator
family (``default_catalog()``): the engine builds one capacity pool per
family and the placement layer scores jobs across them, so each family's
node shapes and unit prices stay independent.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any


@dataclasses.dataclass(frozen=True)
class ResourceDim:
    name: str
    minimum: float
    maximum: float
    base_unit_price: float          # $ per unit-hour at the GCP baseline
    values: tuple[float, ...]       # discrete allocatable amounts

    def unit_price(self, amount: float) -> float:
        """2/3 .. 4/3 of baseline, linear in the provisioned amount."""
        frac = (amount - self.minimum) / max(self.maximum - self.minimum,
                                             1e-12)
        return self.base_unit_price * (2.0 / 3.0 + (2.0 / 3.0) * frac)


def _steps(lo: float, hi: float, step: float) -> tuple[float, ...]:
    out, x = [], lo
    while x <= hi + 1e-9:
        out.append(round(x, 6))
        x += step
    return tuple(out)


class Pricing:
    def __init__(self, dims: list[ResourceDim], family: str = "default"):
        self.dims = {d.name: d for d in dims}
        self.family = family            # accelerator family (pool name)

    def job_cost(self, resources: dict[str, Any], runtime_s: float) -> float:
        """Total_cost = sum_r unit_cost(r) * amount(r) * hours (paper §5.1.2)."""
        hours = runtime_s / 3600.0
        total = 0.0
        for name, dim in self.dims.items():
            amt = float(resources.get(name, dim.minimum))
            total += dim.unit_price(amt) * amt * hours
        return total

    def hourly_rate(self, resources: dict[str, Any]) -> float:
        return self.job_cost(resources, 3600.0)

    def grid(self) -> list[dict[str, float]]:
        names = list(self.dims)
        combos = itertools.product(*(self.dims[n].values for n in names))
        return [dict(zip(names, c)) for c in combos]


# the paper's original space (GCP N1 us-east1 baselines, $/unit-hr)
CPU_PRICING = Pricing([
    ResourceDim("vcpu", 0.5, 8.0, 0.033174, _steps(0.5, 8.0, 0.5)),
    ResourceDim("mem_mb", 512, 8192, 0.004446 / 1024.0,
                _steps(512, 8192, 256)),
], family="cpu")

class ChipScaledPricing(Pricing):
    """TPU pricing: secondary dims (per-chip HBM reservation) scale with the
    chip count — cost = hours * (mu_chip(c)*c + mu_hbm(h)*h*c)."""

    def job_cost(self, resources: dict[str, Any], runtime_s: float) -> float:
        hours = runtime_s / 3600.0
        chips = float(resources.get("chips", self.dims["chips"].minimum))
        total = self.dims["chips"].unit_price(chips) * chips
        for name, dim in self.dims.items():
            if name == "chips":
                continue
            amt = float(resources.get(name, dim.minimum))
            total += dim.unit_price(amt) * amt * chips
        return total * hours


# TPU-pod adaptation: chips replace vCPUs, reserved per-chip HBM replaces MB
TPU_PRICING = ChipScaledPricing([
    ResourceDim("chips", 8, 512, 1.20,
                (8, 16, 32, 64, 128, 256, 512)),
    ResourceDim("hbm_gb", 2, 16, 0.02, _steps(2, 16, 2)),
], family="tpu")


def spot_pricing(pricing: Pricing, discount: float = 0.6,
                 family: str | None = None) -> Pricing:
    """A spot/preemptible catalog entry derived from an on-demand one:
    the same resource dimensions at ``(1 - discount)`` x the unit price
    (GCP spot VMs run 60–91 % below on-demand). The concrete pricing
    subclass is preserved, so chip-scaled TPU pricing stays chip-scaled.
    Pair it with a ``Cluster(spot=True, reclaim_rate=...)`` pool: the
    placement layer prices the reclamation risk into the discount."""
    if not 0.0 < discount < 1.0:
        raise ValueError(f"discount must be in (0, 1), got {discount}")
    dims = [dataclasses.replace(d,
                                base_unit_price=d.base_unit_price
                                * (1.0 - discount))
            for d in pricing.dims.values()]
    return type(pricing)(dims, family or f"{pricing.family}-spot")


def default_catalog() -> dict[str, "Pricing"]:
    """One pricing per accelerator family — the pool catalog the engine
    turns into a heterogeneous deployment (``pricing=default_catalog()``,
    one ``Cluster`` per entry, placement choosing among them)."""
    return {"cpu": CPU_PRICING, "tpu": TPU_PRICING}
