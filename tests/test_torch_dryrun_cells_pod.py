"""The uniform dense, MoE and audio configs' applicable cells of the
multi-pod production mesh (2, 16, 16), counted on fake CPU tensors in a
fake process group of 512 ranks, with the checks of
``test_torch_dryrun_cells.py`` (full width, the layout's smallest depth,
positive FLOPs and bytes, the reference's keys, each family's kernel
records at their ``KernelSpec.cost``)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun_cells import (_cells, _check_cell,  # noqa: E402
                                     _check_records, _uniform)


@pytest.mark.parametrize("arch,shape", _cells(_uniform()))
def test_every_multi_pod_cell_counts(arch, shape):
    got = _check_cell(arch, shape, True)
    if shape == "train_4k":
        # the gradients of the params that data does not shard are summed
        # over "pod" x "data"; FSDP's over data by its reduce-scatter and
        # over "pod" by an all-reduce
        counts = got["roofline"]["collective_counts"]
        assert counts["all-reduce"] > 0 and counts["reduce-scatter"] > 0


def test_the_records_are_the_kernels_at_a_pod_ranks_shard():
    """olmo-1b's prefill on (2, 16, 16): the batch of 32 over "pod" x
    "data" (32 ranks), a rank's 1 row, 1 of 16 heads."""
    recs = _check_records("olmo-1b", "prefill_32k", True)
    assert len(recs) == 1
    assert recs[0]["shape"] == {"b": 1, "s": 32768, "h": 1, "kv": 1,
                                "d": 128, "dtype": "bfloat16"}
