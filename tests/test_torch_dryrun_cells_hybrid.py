"""zamba2-7b's applicable cells on both production meshes, counted on
fake CPU tensors at full width and one period of its layout (5 Mamba-2
layers and the shared attention block, and its 3 trailing layers), with
the checks of ``test_torch_dryrun_cells.py``; and its 500k tick's decode
records at a rank's shard."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun_cells import (HYBRID, _cells,  # noqa: E402
                                     _check_cell, _check_records)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch,shape", _cells(HYBRID))
def test_every_hybrid_cell_counts(arch, shape, multi):
    _check_cell(arch, shape, multi)


def test_the_long_tick_records_are_at_a_ranks_shard():
    """The 500k tick on (16, 16): decode attention at batch 1 over a
    rank's 32768 of 524288 positions (the sequence over the 16 data ranks)
    and 2 of its 32 query and kv heads (over the 16 model ranks)."""
    recs = _check_records("zamba2-7b", "long_500k", False)
    assert {r["name"] for r in recs} == {"decode_attention"}
    assert recs[0]["shape"] == {"b": 1, "s": 524288 // 16, "h": 2, "kv": 2,
                                "d": 112, "dtype": "bfloat16"}
