"""The dry-run's cells against the reference's ``build_cell``: for every
(arch x shape) cell on both production meshes, (16, 16) and (2, 16, 16),
the param, optimizer (ZeRO-1), master and residual, batch and decode-state
specs that ``launch/dryrun.build_cell`` builds the cell's state under
(both serving layouts for the decode cells) equal what the reference's
spec functions give for the same arguments as its ``build_cell``, and the
state's DTensors carry them; ``n/a`` cells give the reference's reason.
The cells are built on fake tensors in a fake process group of the mesh's
size, on the CPU; nothing is counted here (``test_torch_dryrun_cells*``
count)."""
import functools
import math
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs.base import get_arch as ref_arch  # noqa: E402
from repro.configs.shapes import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs.shapes import applicable as ref_applicable  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.sharding import make_abstract_mesh as ref_mesh  # noqa: E402
from repro.sharding import rules as RSR  # noqa: E402
from repro.train.optimizer import opt_state_specs as ref_opt_specs  # noqa: E402
from repro.train.train_step import TrainConfig as RefTrainConfig  # noqa: E402

from repro_torch.configs.base import get_arch, list_archs  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch.mesh import make_mesh, production_shape  # noqa: E402
from repro_torch.sharding import spmd as S  # noqa: E402
from repro_torch.train.train_step import TrainConfig  # noqa: E402

MESHES = {"single": False, "multi": True}


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    return jax.eval_shape(functools.partial(RM.init_params, ref_arch(arch)),
                          jax.random.PRNGKey(0))


def _plain(tree):
    """The reference's spec tree as the port's: dicts, tuples of specs,
    and each PartitionSpec as a tuple of its entries."""
    if isinstance(tree, P):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_plain(v) for v in tree)
    return tree


def _ref_specs(arch, shape_name, multi, tcfg, layout):
    """The spec trees the reference's ``build_cell`` jits the cell with."""
    sizes, names = production_shape(multi_pod=multi)
    cfg, shape = ref_arch(arch), REF_SHAPES[shape_name]
    rules = RSR.AxisRules.for_mesh(ref_mesh(sizes, names))
    resident = layout == "resident" and shape.kind == "decode"
    param_shapes = _ref_shapes(arch)
    pspecs = RSR.param_specs(cfg, rules, fsdp=not resident,
                             param_shapes=param_shapes)
    out = {"params": pspecs,
           "batch": RSR.batch_specs(cfg, shape.kind, shape.global_batch,
                                    rules, layout=layout
                                    if shape.kind == "decode" else "fsdp")}
    if shape.kind == "train":
        ospecs = ref_opt_specs(pspecs, param_shapes, rules, zero=True)
        if tcfg.master_weights:
            ospecs["master"] = ospecs["mu"]
        if tcfg.grad_compression:
            ospecs["residuals"] = pspecs
        out["opt_state"] = ospecs
    if shape.kind == "decode":
        out["state"] = RSR.decode_state_specs(cfg, shape.global_batch, rules,
                                              layout=layout)
    return _plain(out)


def _built(arch, shape_name, multi, tcfg, layout):
    """(the spec trees build_cell built the cell under, [(a state leaf's
    DTensor spec, its tree's spec padded with None to the leaf's rank)])."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    sizes, names = production_shape(multi_pod=multi)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(sizes))
    try:
        mesh = make_mesh(sizes, names, device_type="cpu")
        with FakeTensorMode():
            cell = DR.build_cell(get_arch(arch), SHAPES[shape_name], mesh,
                                 tcfg=tcfg, serve_layout=layout,
                                 device="cpu")
        kind = SHAPES[shape_name].kind
        trees = {"params": cell.args[0]}
        if kind == "train":
            trees["opt_state"] = {k: v for k, v in cell.args[1].items()
                                  if k != "step"}
        if kind == "decode":
            trees["state"] = cell.args[1]
        pairs = []
        for name, tree in trees.items():
            S.map_tree(lambda t, s: pairs.append(
                (S.spec_of(t), tuple(s) + (None,) * (t.dim() - len(s)))),
                tree, {k: cell.specs[name][k] for k in tree}
                if isinstance(tree, dict) else cell.specs[name])
        return cell.specs, pairs
    finally:
        dist.destroy_process_group()


def _cases():
    out = []
    for arch in list_archs():
        for multi in MESHES:
            out.append((arch, multi))
    return out


@pytest.mark.parametrize("arch,mesh", _cases())
def test_every_cell_builds_under_the_references_specs(arch, mesh):
    multi = MESHES[mesh]
    for shape_name, shape in SHAPES.items():
        ok, why = ref_applicable(ref_arch(arch), REF_SHAPES[shape_name])
        if not ok:
            got = DR.run_cell(arch, shape_name, multi_pod=multi,
                              out_dir=None, verbose=False, device="cpu")
            assert got == {"arch": arch, "shape": shape_name,
                           "multi_pod": multi, "status": "n/a",
                           "reason": why}
            continue
        layouts = ("fsdp", "resident") if shape.kind == "decode" \
            else ("fsdp",)
        for layout in layouts:
            specs, placed = _built(arch, shape_name, multi, TrainConfig(),
                                   layout)
            want = _ref_specs(arch, shape_name, multi, RefTrainConfig(),
                              layout)
            assert specs.keys() == want.keys()
            for name in want:
                assert _plain(specs[name]) == want[name], \
                    (arch, shape_name, layout, name)
            for got_spec, spec in placed:
                assert got_spec == spec, (arch, shape_name, layout)


def test_master_weights_and_residuals_take_the_references_specs():
    """``master_weights`` (bf16 params, fp32 masters under the moments'
    specs) and ``grad_compression`` (residuals under the params')."""
    tcfg = TrainConfig(master_weights=True, grad_compression="int8")
    ref = RefTrainConfig(master_weights=True, grad_compression="int8")
    specs, placed = _built("olmo-1b", "train_4k", False, tcfg, "fsdp")
    want = _ref_specs("olmo-1b", "train_4k", False, ref, "fsdp")
    for name in want:
        assert _plain(specs[name]) == want[name], name
    assert {"master", "residuals"} <= set(specs["opt_state"])
    for got_spec, spec in placed:
        assert got_spec == spec


def test_input_specs_equal_the_references():
    # the reference's module sets XLA_FLAGS (512 host devices) as it is
    # imported; this process's JAX keeps its own
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import input_specs as ref_input_specs
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    for arch in list_archs():
        for shape_name in SHAPES:
            ref = ref_input_specs(ref_arch(arch), REF_SHAPES[shape_name])
            got = DR.input_specs(get_arch(arch), SHAPES[shape_name])
            assert got.keys() == ref.keys()
            for k, spec in got.items():
                assert spec.shape == tuple(ref[k].shape)
                assert str(spec.dtype).removeprefix("torch.") == \
                    str(ref[k].dtype)
