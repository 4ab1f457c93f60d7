"""Per-family feature spaces for the profiling templates of the card's
jobs (DESIGN.md §6).

The paper's command-template "hints" become architecture-aware resource
dimensions: every family profiles (steps, chips, hbm_gb); MoE families add
the expert-parallel width, long-context serving adds the KV sharding width.

A copy of ``repro/core/provision/features.py``, with its imports in
``repro_torch``. Its dimensions and hints stay the reference's: ``chips``
counts accelerator cards, and ``hbm_gb`` is the device memory a job asks
for.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.core.provision.profiler import CommandTemplate


def template_for(cfg: ArchConfig, shape_name: str,
                 steps_hints=(50, 100, 200),
                 chips_hints=(8, 32, 128),
                 hbm_hints=(4, 8, 16)) -> CommandTemplate:
    hints = {"steps": list(steps_hints)}
    resources = {"chips": list(chips_hints), "hbm_gb": list(hbm_hints)}
    if cfg.moe is not None:
        # EP width must divide the expert count
        resources["ep_width"] = [w for w in (2, 4, 8, 16)
                                 if cfg.moe.n_experts % w == 0]
    if shape_name == "long_500k" and cfg.subquadratic:
        resources["kv_shard"] = [16, 64, 256]
    return CommandTemplate(name=f"{cfg.name}-{shape_name}", hints=hints,
                           resource_hints=resources)
