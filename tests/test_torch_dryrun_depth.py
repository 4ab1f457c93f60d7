"""A dry-run count is linear in depth, as the reference's HLO model is in
its scan's trip count: olmo-1b's train cell and zamba2-7b's prefill cell
(full width, (16, 16), fake CPU tensors) counted at two depths that keep
the layout extrapolate to the full depth's count within 1% (FLOPs, bytes,
fused bytes, collective bytes), and the kernel records exactly."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402

FIELDS = ("flops", "bytes", "bytes_fused", "coll_bytes")


def _count(arch, shape, layers):
    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    cost = DR.count_cell(cfg, SHAPES[shape], (16, 16),
                         tcfg=DR.TrainConfig(), device="cpu")["cost"]
    return {**{f: getattr(cost, f) for f in FIELDS},
            "records": len(cost.kernels)}


@pytest.mark.parametrize("arch,shape,depths", [
    ("olmo-1b", "train_4k", (1, 2, 16)),
    # one and two periods of 5 Mamba-2 layers and the shared block, each
    # with the 3 trailing layers; the whole model is 13 periods and 3
    ("zamba2-7b", "prefill_32k", (9, 15, 81))])
def test_counts_extrapolate_linearly_in_depth(arch, shape, depths):
    lo, hi, full = depths
    a, b, want = (_count(arch, shape, d) for d in depths)
    for field in (*FIELDS, "records"):
        slope = (b[field] - a[field]) / (hi - lo)
        got = a[field] + slope * (full - lo)
        if field == "records":
            assert got == want[field]
        else:
            assert got == pytest.approx(want[field], rel=1e-2), field
