"""Every applicable (arch x shape) cell counts through
``launch/dryrun.run_cell``'s path on fake CPU tensors in a fake process
group of the production mesh's 256 or 512 ranks: full width, the depth cut
to the smallest that keeps the layout (one layer of a uniform stack; one
period and its trailing layers of a periodic one). Each result has
positive FLOPs and bytes, the reference's JSON keys and the kernel records
its family's path implies (none in a train step; flash per attention
layer in a prefill, WKV6 per RWKV layer, SSD per Mamba-2 layer; decode
attention per attention layer in a tick), each at its ``KernelSpec.cost``.

The cells are split over four files so that each runs well under 90 s:
this one counts the uniform dense, MoE and audio configs on the
single-pod mesh (16, 16), ``test_torch_dryrun_cells_pod.py`` the same on
(2, 16, 16), ``test_torch_dryrun_cells_hybrid.py`` zamba2-7b on both and
``test_torch_dryrun_cells_ssm_vlm.py`` rwkv6-7b and llama-3.2-vision-11b
on both."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_arch, list_archs  # noqa: E402
from repro_torch.configs.shapes import SHAPES, applicable  # noqa: E402
from repro_torch.core.provision.autotune import KERNELS  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.models.transformer import build_layout  # noqa: E402

# the reference's run_cell keys, and its roofline's (one renamed)
CELL_KEYS = {"arch", "shape", "multi_pod", "status", "n_chips", "lower_s",
             "compile_s", "memory_analysis", "roofline", "train_config"}
ROOF_KEYS = {"flops_per_device", "bytes_per_device",
             "collective_bytes_per_device", "collective_breakdown",
             "collective_counts", "compute_s", "memory_s", "collective_s",
             "dominant", "step_time_s", "model_flops", "useful_flops_ratio",
             "roofline_fraction", "n_chips", "fused_program_reference"}
MEM_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes"}


def _cut(arch):
    """arch at full width and the smallest depth that keeps its layout."""
    cfg = get_arch(arch)
    lay = build_layout(cfg)
    depth = 1 if lay["kind"] == "uniform" else \
        lay["inner_n"] + 1 + lay["trailing"]
    return dataclasses.replace(cfg, n_layers=depth)


def _launches(cfg, kind):
    """{kernel: launches} of one step of ``kind`` on ``cfg``'s path."""
    kinds = cfg.layer_kinds()
    attn = sum(k in ("dense", "moe", "shared_attn") for k in kinds)
    if kind == "prefill":
        got = {"flash_attention": attn,
               "rwkv6": kinds.count("rwkv"),
               "mamba2_ssd": kinds.count("mamba")}
    elif kind == "decode":
        got = {"decode_attention": attn}
    else:
        got = {}
    return {k: n for k, n in got.items() if n}


# the configs the other files count; the rest is this file's and the pod
# file's
HYBRID = ("zamba2-7b",)
SSM_VLM = ("rwkv6-7b", "llama-3.2-vision-11b")


def _cells(archs):
    """(arch, shape) of each applicable cell of ``archs``."""
    return [(arch, shape) for arch in archs for shape in SHAPES
            if applicable(get_arch(arch), SHAPES[shape])[0]]


def _uniform():
    return [a for a in list_archs() if a not in HYBRID + SSM_VLM]


def _check_cell(arch, shape_name, multi):
    cfg = _cut(arch)
    got = DR.run_cell(arch, shape_name, multi_pod=multi, cfg=cfg,
                      device="cpu", out_dir=None, verbose=False)
    json.dumps(got)
    assert got["status"] == "ok" and CELL_KEYS <= set(got)
    assert got["n_chips"] == (512 if multi else 256)
    assert got["compile_s"] is None and got["lower_s"] > 0
    assert set(got["memory_analysis"]) == MEM_KEYS
    assert got["memory_analysis"]["argument_size_in_bytes"] > 0
    roof = got["roofline"]
    assert ROOF_KEYS <= set(roof)
    assert roof["flops_per_device"] > 0 and roof["bytes_per_device"] > 0
    assert roof["step_time_s"] > 0
    assert roof["fused_program_reference"]["bytes_fused"] <= \
        roof["bytes_per_device"]
    kind = SHAPES[shape_name].kind
    assert {k: t["launches"] for k, t in roof["kernels"].items()} == \
        _launches(cfg, kind)
    return got


def _check_records(arch, shape_name, multi):
    """Each kernel record of the cell's count at its ``KernelSpec.cost``."""
    from repro_torch.launch.mesh import production_shape
    cfg = _cut(arch)
    count = DR.count_cell(cfg, SHAPES[shape_name],
                          production_shape(multi_pod=multi)[0],
                          tcfg=DR.TrainConfig(), device="cpu")
    recs = count["cost"].kernels
    assert recs
    for rec in recs:
        kw = {"valid": rec["shape"]["b"] * rec["shape"]["s"]} \
            if rec["name"] == "decode_attention" else {}
        assert (rec["flops"], rec["bytes"]) == \
            KERNELS[rec["name"]].cost(rec["shape"], **kw)
        assert rec["shape"]["dtype"] == "bfloat16"
    return recs


@pytest.mark.parametrize("arch,shape", _cells(_uniform()))
def test_every_single_pod_cell_counts(arch, shape):
    _check_cell(arch, shape, False)


def test_the_records_are_the_kernels_at_a_ranks_shard():
    """olmo-1b's prefill: flash at a rank's 2 rows of 32 (the batch over
    16 data ranks) and 1 of 16 heads (over 16 model ranks)."""
    recs = _check_records("olmo-1b", "prefill_32k", False)
    assert {r["name"] for r in recs} == {"flash_attention"}
    assert recs[0]["shape"] == {"b": 2, "s": 32768, "h": 1, "kv": 1,
                                "d": 128, "dtype": "bfloat16"}
