"""The loss over vocab shards: on a model axis above 1, ``model.loss_fn``
keeps each rank's vocab columns of the logits and all-reduces each row's
max (MAX) and its sum of exponentials and gold logit (SUM) over "model",
as the reference's partitioner does (``model.vocab_sharded_nll``).

Held against the reference's sharded step (one JAX process on 4 forced
host devices, ``tests/jax_mesh_reference.py``'s ``loss`` part, meshes of
``AxisType.Auto`` axes) on (1, 2), (2, 2) and (2, 1, 2), for a tied table
(olmo-1b), an untied head (qwen3-8b) and musicgen-large's codebook-major
head, at 4 codebooks (2 whole ones a rank) and at 3 (a rank's 384
columns split a codebook), with ignored labels; gloo CPU ranks of
``tests/torch_mesh_ranks.py``'s ``loss4`` and ``loss2``. The dry-run's
count of a reduced train cell on a fake (2, 2) mesh shows that no rank
gathers the logits or holds a (rows, S, V) tensor.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.roofline import op_cost  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import jax_mesh_reference as JR  # noqa: E402
import torch_mesh_ranks as TR  # noqa: E402

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
SPAWN_TIMEOUT = 300
REF_TIMEOUT = 600
# test_torch_mesh.py's fp32 tolerances: the partitioner and the ranks sum
# in other orders
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def outdir(tmp_path_factory):
    return tmp_path_factory.mktemp("loss_vocab")


@pytest.fixture(scope="module")
def ref_path(outdir):
    path = outdir / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run(
        [sys.executable, str(TESTS / "jax_mesh_reference.py"), str(path),
         "loss"], env=env, text=True, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, timeout=REF_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return path


@pytest.fixture(scope="module")
def ref(ref_path):
    with np.load(ref_path) as got:
        return {k: got[k] for k in got.files}


@pytest.fixture(scope="module")
def ranks(ref_path, outdir):
    """{world: (npz, meta)} of the ``loss4`` and ``loss2`` spawns."""
    return {4: TR.spawn("loss4", 4, outdir, ref_path, SPAWN_TIMEOUT),
            2: TR.spawn("loss2", 2, outdir, ref_path, SPAWN_TIMEOUT)}


def _world(case):
    return int(np.prod(JR.LOSS_CASES[case][1]))


def _grads(npz, prefix):
    n = len(prefix) + 1
    return {k[n:]: npz[k] for k in npz.files if k.startswith(prefix + "/")}


@pytest.mark.parametrize("case", list(JR.LOSS_CASES))
def test_vocab_sharded_loss_and_grads_match_reference(ranks, ref, case):
    got = ranks[_world(case)][0]
    np.testing.assert_allclose(got[f"loss/{case}/loss"],
                               ref[f"loss/{case}/loss"], **GRAD_TOL)
    want = {k[len(f"loss/{case}/grad/"):]: v for k, v in ref.items()
            if k.startswith(f"loss/{case}/grad/")}
    mine = _grads(got, f"loss/{case}/grad")
    assert set(mine) == set(want)
    for k in want:
        np.testing.assert_allclose(mine[k], want[k], err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("case", list(JR.LOSS_CASES))
def test_no_rank_holds_a_tensor_as_wide_as_the_whole_head(ranks, case):
    """No op of a rank's step (forward and backward) gives a tensor of 2
    dims or more whose last dim is the head's whole K V: the logits, their
    softmax and their gradient stay at the rank's columns."""
    assert ranks[_world(case)][1]["widest_rows"][case] == \
        [0] * _world(case)


# ---------------------------------------------------------------------------
# the autograd function alone, on a world of one rank
# ---------------------------------------------------------------------------

@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("books", [0, 1, 3])
def test_nll_and_its_backward_equal_logsumexp_minus_gold(world_of_one,
                                                         books):
    """On one rank (all columns, col0 0) the function's value is logsumexp
    minus the gold logit per codebook, and its hand-written backward is
    autograd's through those, ignored labels included (their gradient
    zero through the mask)."""
    vocab = 7
    k = books or 1
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 5, k * vocab))).double()
    labels = torch.from_numpy(rng.integers(0, vocab, (2, 5, k)))
    valid = torch.from_numpy(rng.random((2, 5, k)) > 0.2)
    up = torch.from_numpy(rng.standard_normal((2, 5, k))).double()

    a = x.clone().requires_grad_()
    got = M._VocabShardedNLL.apply(a, labels, vocab, 0, world_of_one)
    (got * valid * up).sum().backward()
    b = x.clone().requires_grad_()
    per = b.unflatten(-1, (k, vocab))
    want = torch.logsumexp(per, -1) - per.gather(-1, labels[..., None])[..., 0]
    (want * valid * up).sum().backward()
    torch.testing.assert_close(got, want.detach(), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# the dry-run: no gather of the logits, no (rows, S, V) tensor
# ---------------------------------------------------------------------------

class _Shapes(op_cost.Counter):
    """A counter that also keeps the shape of every op's tensor outputs."""

    def __init__(self, known):
        super().__init__(known)
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-8b"])
def test_dry_run_train_cell_neither_gathers_nor_holds_whole_logits(
        arch, monkeypatch):
    """Reduced olmo-1b (a tied table) and qwen3-8b (an untied head), the
    reference's small train cell (8 rows of 128 tokens) on a fake (2, 2)
    mesh: a rank's rows are 4, its vocab columns V / 2. No all-gather
    takes a (4, 128, V / 2) shard and no op gives a tensor of the rank's
    rows x 128 x V."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    cfg = get_arch(arch).reduced()
    shape = JR.dryrun_shape("train", ShapeConfig)
    rows = shape.global_batch // JR.DRYRUN_MESH[0]
    local = (rows, shape.seq_len, cfg.vocab_size // JR.DRYRUN_MESH[1])
    gathered = []
    orig = dist.all_gather

    def all_gather(tensor_list, tensor, *a, **kw):
        gathered.append(tuple(tensor.shape))
        return orig(tensor_list, tensor, *a, **kw)
    monkeypatch.setattr(dist, "all_gather", all_gather)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_mesh(JR.DRYRUN_MESH, ("data", "model"), device_type="cpu")
        with FakeTensorMode():
            cell = DR.build_cell(cfg, shape, mesh, tcfg=DR.TrainConfig(),
                                 device="cpu")
            with _Shapes(cell.args) as counter:
                cell.step(*cell.args)
    finally:
        dist.destroy_process_group()
    assert gathered, "the step gathers its FSDP params"
    assert local not in gathered
    whole = rows * shape.seq_len * cfg.vocab_size
    assert not [s for s in counter.shapes
                if s and s[-1] == cfg.vocab_size
                and int(np.prod(s)) >= whole]
    assert counter.cost.coll_count.get("all-reduce", 0) > 0
