"""Assigned input shapes and (arch x shape) applicability rules: the
shapes of the jobs the card runs and the profiler's templates describe.

A copy of ``repro/configs/shapes.py``, with its imports in
``repro_torch.configs``; the shapes stay the reference's."""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable?, reason-if-not). long_500k needs sub-quadratic sequence
    handling -> SSM/hybrid only (see DESIGN.md §6)."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, ("pure full-attention arch: 500k-token KV decode is "
                       "quadratic-prefill territory; skipped per assignment")
    return True, ""


def cells(archs: list[ArchConfig]) -> list[tuple[ArchConfig, ShapeConfig, bool, str]]:
    out = []
    for a in archs:
        for s in SHAPES.values():
            ok, why = applicable(a, s)
            out.append((a, s, ok, why))
    return out
