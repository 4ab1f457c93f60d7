"""Roofline analysis of a counted step (the port of
``repro/roofline/analysis.py``).

Three terms per (arch x shape x mesh), all in seconds:

    compute    = flops_per_device / peak_flops
    memory     = bytes_per_device / hbm_bw
    collective = collective_bytes_per_device / link_bw

The cost source is ``roofline/op_cost.py``'s count of one rank's step on
fake tensors (the reference's is ``hlo_cost``'s reading of the compiled
HLO). Its memory term reads ``Cost.bytes``, every op's operands and
result, since the port runs eagerly and each elementwise op goes through
HBM; the reference's reads the fused bytes, XLA's fusion on a TPU. The
fused bytes stay in the output as what a fused program would move.

The hardware is the NVIDIA H100 SXM of ``roofline/prior.py``'s ``H100``,
which holds the constants (the reference's ``prior`` imports its TPU
constants from here; here it is the other way round): 989 TFLOP/s dense
bf16, 3.35 TB/s of HBM3, and 450 GB/s a card each way over NVLink 4. Past
8 cards (one NVLink domain) a device's collective bytes leave it over the
network, whose rate a card is a fraction of NVLink's; this module keeps the
reference's one link constant for every mesh, so on the production meshes
(256 and 512 cards) the collective term is a floor, not an estimate.

Renamed keys of ``Roofline.as_dict`` (every other key is the reference's):

- ``xla_cost_analysis_reference`` (XLA's ``cost_analysis()`` flops and
  bytes, and the HLO model's all-op bytes) -> ``fused_program_reference``:
  the count's ``bytes_fused`` and the memory term it would give
  (``memory_s_fused``).

Added keys: ``kernels``, the count's kernel records tallied by kernel
(launches, flops, bytes), and ``hardware``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.roofline.op_cost import COLL_KINDS, Cost
from repro_torch.roofline.prior import H100

PEAK_FLOPS = H100.peak_flops
HBM_BW = H100.hbm_bw
ICI_BW = H100.ici_bw


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict[str, int]
    count_by_kind: dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def collective_stats(cost: Cost) -> CollectiveStats:
    """The count's collectives by kind (``parse_collectives``' role: the
    reference reads them off the HLO text), each of the reference's five
    kinds present, 0 where none ran."""
    bytes_by = {k: 0 for k in COLL_KINDS}
    count_by = {k: 0 for k in COLL_KINDS}
    for k, v in cost.coll_by_kind.items():
        bytes_by[k] = int(v)
        count_by[k] = int(cost.coll_count.get(k, 0))
    return CollectiveStats(bytes_by, count_by)


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    collectives: CollectiveStats
    model_flops: float               # 6*N*D (train) / 2*N*tokens (serve)
    n_chips: int
    bytes_fused: float = 0.0
    kernels: dict = dataclasses.field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / ICI_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step-time estimate = max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total counted FLOPs: remat and redundancy."""
        total = self.flops_per_device * self.n_chips
        return self.model_flops / total if total else float("nan")

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the cards' peak spent on *useful* model FLOPs if the
        step ran at the roofline estimate: MODEL_FLOPS / (chips * peak *
        step_time)."""
        denom = self.n_chips * PEAK_FLOPS * self.step_time_s
        return self.model_flops / denom if denom else float("nan")

    def as_dict(self) -> dict[str, Any]:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes,
            "collective_breakdown": self.collectives.bytes_by_kind,
            "collective_counts": self.collectives.count_by_kind,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "n_chips": self.n_chips,
            "fused_program_reference": {
                "bytes_fused": self.bytes_fused,
                "memory_s_fused": self.bytes_fused / HBM_BW},
            "kernels": self.kernels,
            "hardware": {"name": H100.family, "peak_flops": PEAK_FLOPS,
                         "hbm_bw": HBM_BW, "link_bw": ICI_BW},
        }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N_active*D (train) or 2*N_active*tokens (fwd-only)."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    # decode: one token per sequence + attention KV read flops
    flops = 2.0 * n * shape.global_batch
    if not cfg.attention_free:
        hd = cfg.resolved_head_dim
        n_attn_layers = sum(1 for k in cfg.layer_kinds()
                            if k in ("dense", "moe", "shared_attn"))
        flops += (4.0 * cfg.n_heads * hd * shape.seq_len
                  * shape.global_batch * n_attn_layers)
    return flops


def analyze(cost: Cost, cfg, shape, n_chips: int) -> Roofline:
    """The roofline of one rank's counted step (``op_cost.Cost``) on a mesh
    of ``n_chips`` cards, with the H100's constants."""
    return Roofline(
        flops_per_device=cost.flops,
        bytes_per_device=cost.bytes,
        collective_bytes=float(cost.coll_bytes),
        collectives=collective_stats(cost),
        model_flops=model_flops(cfg, shape),
        n_chips=n_chips,
        bytes_fused=cost.bytes_fused,
        kernels=cost.kernel_tally(),
    )
