"""rwkv6-7b's and llama-3.2-vision-11b's applicable cells on both
production meshes, counted on fake CPU tensors at full width and the
smallest depth that keeps each layout (one RWKV layer; one period of 4
dense and 1 cross-attention layer), with the checks of
``test_torch_dryrun_cells.py``."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun_cells import SSM_VLM, _cells, _check_cell  # noqa: E402


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch,shape", _cells(SSM_VLM))
def test_every_ssm_and_vlm_cell_counts(arch, shape, multi):
    _check_cell(arch, shape, multi)
