#!/usr/bin/env python3
"""Render the dry-run's cell files as a markdown table, one row per
(arch x shape), the single-pod (16, 16) and multi-pod (2, 16, 16) values
side by side as "single / multi"; then the n/a cells with their reason.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --all
    python3 tools/dryrun_table.py build/dryrun

Every number is a prediction from the H100's data-sheet constants
(``roofline/analysis.py``) over a count on fake tensors, not a
measurement. The peak is the arguments plus the step's own peak of live
bytes against the card's 80 GB; the count's seconds are the dry-run's own
(CPU) time for the cell.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _pair(cells, fn):
    return " / ".join(fn(cells[mp]) if mp in cells else "not counted"
                      for mp in ("single", "multi"))


def main(directory: str) -> int:
    found = {}
    for path in sorted(Path(directory).glob("*.json")):
        cell = json.loads(path.read_text())
        mesh = "multi" if cell["multi_pod"] else "single"
        found.setdefault((cell["arch"], cell["shape"]), {})[mesh] = cell
    rows, skipped = [], {}
    for (arch, shape), cells in sorted(
            found.items(), key=lambda kv: (kv[0][0], SHAPES.index(kv[0][1]))):
        if cells["single"]["status"] != "ok":
            skipped.setdefault(cells["single"]["reason"], []).append(
                f"{arch} x {shape}")
            continue
        roof = lambda c, k: c["roofline"][k]  # noqa: E731
        rows.append("| " + " | ".join([
            arch, shape,
            _pair(cells, lambda c: f"{roof(c, 'flops_per_device'):.3e}"),
            _pair(cells, lambda c: f"{roof(c, 'bytes_per_device'):.3e}"),
            _pair(cells, lambda c:
                  f"{roof(c, 'collective_bytes_per_device'):.3e}"),
            _pair(cells, lambda c: roof(c, "dominant")),
            _pair(cells, lambda c: f"{roof(c, 'step_time_s'):.4g}"),
            _pair(cells, lambda c: f"{roof(c, 'useful_flops_ratio'):.3f}"),
            _pair(cells, lambda c: f"{c['predicted_peak_bytes'] / 1e9:.1f}"
                  + ("" if c["fits_80gb"] else " (over)")),
            _pair(cells, lambda c: f"{c['lower_s']:.1f}")]) + " |")
    print("| arch | shape | FLOPs/device | bytes/device | collective "
          "bytes/device | dominant | step_time_s | useful_flops_ratio | "
          "peak GB (of 80) | count s |")
    print("| --- " * 10 + "|")
    print("\n".join(rows))
    print()
    counted = sum(len(c) for c in found.values()) \
        - 2 * sum(len(v) for v in skipped.values())
    print(f"{counted} cells counted. n/a on both meshes: " + "; ".join(
        f"{', '.join(cells)} ({reason})" for reason, cells in
        skipped.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "build/dryrun"))
