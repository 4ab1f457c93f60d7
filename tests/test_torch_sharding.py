"""The port's sharding rules against the reference's, with no process group:
``param_specs`` (FSDP on and off), ``opt_state_specs`` (ZeRO-1),
``batch_specs`` (train, prefill, decode, the small-batch fallback) and
``decode_state_specs`` (both layouts) equal the reference's entry for entry
for all 10 archs on the abstract production meshes (16, 16) and
(2, 16, 16), and every sharded dim divides."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.base import get_arch as ref_arch  # noqa: E402
from repro.configs.base import list_archs  # noqa: E402
from repro.configs.shapes import SHAPES, applicable  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.sharding import make_abstract_mesh as ref_mesh  # noqa: E402
from repro.sharding import rules as RSR  # noqa: E402
from repro.train.optimizer import opt_state_specs as ref_opt_specs  # noqa: E402

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.sharding import make_abstract_mesh  # noqa: E402
from repro_torch.sharding import rules as SR  # noqa: E402
from repro_torch.sharding.mesh import axis_sizes  # noqa: E402
from repro_torch.train.optimizer import opt_state_specs  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = list_archs()


def _rules(mesh_name):
    sizes, names = MESHES[mesh_name]
    return (SR.AxisRules.for_mesh(make_abstract_mesh(sizes, names)),
            RSR.AxisRules.for_mesh(ref_mesh(sizes, names)))


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    return jax.eval_shape(functools.partial(RM.init_params, ref_arch(arch)),
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    return M.param_shapes(get_arch(arch))


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


def _divides(shape, spec, mesh):
    sizes = axis_sizes(mesh)
    assert len(spec) <= len(shape), (shape, spec)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n = 1
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            n *= sizes[name]
        assert shape[dim] % n == 0, (shape, spec, dim)


def _pairs(shapes, specs):
    if isinstance(specs, dict):
        for k in specs:
            yield from _pairs(shapes[k], specs[k])
    elif specs and isinstance(specs[0], tuple) and not (
            isinstance(shapes, torch.Size)):
        for sh, sp in zip(shapes, specs):
            yield from _pairs(sh, sp)
    else:
        yield tuple(shapes), specs


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference_and_divide(arch, mesh_name, fsdp):
    rules, ref_rules = _rules(mesh_name)
    shapes = _shapes(arch)
    got = SR.param_specs(get_arch(arch), rules, fsdp=fsdp,
                         param_shapes=shapes)
    want = _plain(RSR.param_specs(ref_arch(arch), ref_rules, fsdp=fsdp,
                                  param_shapes=_ref_shapes(arch)))
    assert got == want
    for shape, spec in _pairs(shapes, got):
        _divides(shape, spec, rules.mesh)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_equal_reference_and_divide(arch, mesh_name):
    rules, ref_rules = _rules(mesh_name)
    shapes = _shapes(arch)
    pspecs = SR.param_specs(get_arch(arch), rules, fsdp=True,
                            param_shapes=shapes)
    got = opt_state_specs(pspecs, shapes, rules)
    ref_p = RSR.param_specs(ref_arch(arch), ref_rules, fsdp=True,
                            param_shapes=_ref_shapes(arch))
    want = _plain(ref_opt_specs(ref_p, _ref_shapes(arch), ref_rules))
    assert set(got) == {"mu", "nu", "step"}
    assert got == want
    for shape, spec in _pairs(shapes, got["mu"]):
        _divides(shape, spec, rules.mesh)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("global_batch", [256, 1])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_reference(arch, kind, global_batch, mesh_name):
    rules, ref_rules = _rules(mesh_name)
    got = SR.batch_specs(get_arch(arch), kind, global_batch, rules)
    want = _plain(RSR.batch_specs(ref_arch(arch), kind, global_batch,
                                  ref_rules))
    assert got == want
    # the small-batch fallback (tests/test_sharding.py)
    assert (got["tokens"][0] is not None) == (global_batch == 256)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("layout", ["fsdp", "resident"])
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_specs_equal_reference(arch, shape_name, layout,
                                            mesh_name):
    rules, ref_rules = _rules(mesh_name)
    cfg, shape = get_arch(arch), SHAPES[shape_name]
    got = SR.decode_state_specs(cfg, shape.global_batch, rules,
                                layout=layout)
    want = _plain(RSR.decode_state_specs(ref_arch(arch), shape.global_batch,
                                         ref_rules, layout=layout))
    assert got == want
    if cfg.family == "vlm" or not applicable(ref_arch(arch), shape)[0]:
        return      # the VLM's state needs vision and params to build
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        state = T.init_decode_state(cfg, shape.global_batch, shape.seq_len)
    for st, sp in zip(state.values(), got.values()):
        for t, s in zip(st, sp):
            _divides(tuple(t.shape), s, rules.mesh)


def test_logical_to_spec_empty_without_rules():
    SR.set_rules(None)
    assert SR.logical_to_spec(("batch", None)) == ()
    assert SR.logical_to_spec(("tp",)) == ()


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_logical_to_spec_equal_reference(mesh_name):
    rules, ref_rules = _rules(mesh_name)
    for logical in [("batch", None, None), ("tp",), ("longseq", "kvseq"),
                    ("zero", None), ("nope",)]:
        assert SR.logical_to_spec(logical, rules) == \
            tuple(RSR.logical_to_spec(logical, ref_rules))
    assert rules.table == ref_rules.table
