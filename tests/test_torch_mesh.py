"""The port on a mesh: ranks spawned on gloo (CPU), small configs, held
against the reference's mesh results (one JAX process on 4 forced host
devices, ``tests/jax_mesh_reference.py``, meshes of ``AxisType.Auto``
axes) and against the port's one-device path.

One spawn of 4 ranks and one of 2 serve every case
(``tests/torch_mesh_ranks.py``); ranks meet through a FileStore in the
test's temporary directory, and each spawn has a timeout of its own.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import compression as RC  # noqa: E402
from repro.train.pipeline import sequential_apply  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.core.acai import AcaiProject  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.sharding import make_abstract_mesh  # noqa: E402
from repro_torch.sharding import spmd as S  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.train.checkpoints import CheckpointManager  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import jax_mesh_reference as JR  # noqa: E402
import torch_mesh_ranks as TR  # noqa: E402

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
SPAWN_TIMEOUT = 300
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(SRC), **extra)
    env.setdefault("OMP_NUM_THREADS", "1")
    return env


@pytest.fixture(scope="module")
def outdir(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh")


@pytest.fixture(scope="module")
def ref_path(outdir):
    path = outdir / "ref.npz"
    proc = subprocess.run(
        [sys.executable, str(TESTS / "jax_mesh_reference.py"), str(path)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                 JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return path


@pytest.fixture(scope="module")
def ref(ref_path):
    return np.load(ref_path)


@pytest.fixture(scope="module")
def four(ref_path, outdir):
    return TR.spawn("four", 4, outdir, ref_path, SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def two(four, ref_path, outdir):
    return TR.spawn("two", 2, outdir, ref_path, SPAWN_TIMEOUT)


# ---------------------------------------------------------------------------
# DTensor state on (2, 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TR.FULL_SPECS))
def test_full_tensor_rebuilds_a_dim_sharded_over_both_axes(four, name):
    """Rank (d, m) = 2 d + m holds the reference's chunk of each sharded
    dim (over ("data", "model"): chunk 2 d + m), and ``full_tensor``
    gathers the global tensor back on every rank, as DTensor's own does."""
    spec = TR.FULL_SPECS[name]
    full = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    for r in range(4):
        d, m = divmod(r, 2)
        want = full
        for dim, entry in enumerate(spec):
            idx, n = {None: (0, 1), "data": (d, 2), "model": (m, 2),
                      ("data", "model"): (2 * d + m, 4)}[entry]
            want = np.split(want, n, axis=dim)[idx]
        np.testing.assert_array_equal(four[0][f"full/{name}/local"][r],
                                      want)
        np.testing.assert_array_equal(four[0][f"full/{name}/ours"][r], full)
        np.testing.assert_array_equal(four[0][f"full/{name}/dtensor"][r],
                                      full)


# ---------------------------------------------------------------------------
# (a) compressed_psum, (b) GPipe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_compressed_psum_equals_sum_of_reference_roundtrips(four, kind):
    """Every rank's result is the sum over ranks (in rank order, fp32) of
    the reference's decompress(*compress(x_r)), bit for bit."""
    want = None
    for r in range(4):
        x = np.random.default_rng(r).standard_normal(TR.PSUM_SHAPE).astype(
            np.float32) * (r + 1)
        part = np.asarray(RC.decompress(*RC.compress(jnp.asarray(x), kind)))
        want = part if want is None else want + part
    got = four[0][f"psum/{kind}"]
    assert got.dtype == np.float32 and got.shape == (4, *TR.PSUM_SHAPE)
    for r in range(4):
        np.testing.assert_array_equal(got[r], want)


def test_gpipe_matches_reference_sequential_apply(four):
    n_st, n_mb, b, w = TR.GPIPE
    rng = np.random.default_rng(11)
    stacked = {"w": (rng.standard_normal((n_st, w, w))
                     / np.sqrt(w)).astype(np.float32),
               "b": rng.standard_normal((n_st, w)).astype(np.float32)}
    x = rng.standard_normal((b, w)).astype(np.float32)
    want = np.asarray(sequential_apply(
        lambda p, a: jnp.tanh(a @ p["w"] + p["b"]),
        jax.tree.map(jnp.asarray, stacked), jnp.asarray(x)))
    got = four[0]["gpipe/y"]
    for r in range(n_st):          # every stage holds the last one's output
        np.testing.assert_allclose(got[r], want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# (c) the sharded train step on (2, 2)
# ---------------------------------------------------------------------------

def _grads(npz, prefix):
    n = len(prefix) + 1
    return {k[n:]: npz[k] for k in npz.files if k.startswith(prefix + "/")}


@pytest.mark.parametrize("arch", JR.TRAIN_ARCHS)
def test_sharded_loss_and_grads_match_reference(four, ref, arch):
    got = four[0]
    np.testing.assert_allclose(got[f"train/{arch}/loss"],
                               ref[f"train/{arch}/loss"], **GRAD_TOL)
    want = _grads(ref, f"train/{arch}/grad")
    mine = _grads(got, f"train/{arch}/grad")
    assert set(mine) == set(want)
    for k in want:
        np.testing.assert_allclose(mine[k], want[k], err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("arch", JR.TRAIN_ARCHS)
def test_sharded_loss_and_grads_match_one_device(four, arch):
    got = four[0]
    np.testing.assert_allclose(got[f"train/{arch}/loss"],
                               got[f"one/{arch}/loss"], **GRAD_TOL)
    want = _grads(got, f"one/{arch}/grad")
    mine = _grads(got, f"train/{arch}/grad")
    assert set(mine) == set(want)
    for k in want:
        np.testing.assert_allclose(mine[k], want[k], err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("arch", JR.TRAIN_ARCHS)
def test_three_sharded_steps_match_reference(four, ref, arch):
    """Losses, not params: AdamW's first update is about +-lr for every
    gradient, so a tiny gradient whose sign flips under another reduction
    order moves its weight by 2 lr (ROADMAP C)."""
    np.testing.assert_allclose(four[0][f"train/{arch}/steps"],
                               ref[f"train/{arch}/steps"], rtol=1e-4)
    np.testing.assert_allclose(four[0][f"train/{arch}/steps"],
                               four[0][f"one/{arch}/steps"], rtol=1e-4)


@pytest.mark.parametrize("arch", JR.TRAIN_ARCHS)
def test_local_shards_have_the_specs_shapes(four, arch):
    cfg = get_arch(arch).reduced()
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    _, pspecs, ospecs = TS.sharded_specs(cfg, mesh)
    shapes = convert.flatten(M.param_shapes(cfg))
    want = {name: {k: list(S.local_shape(shapes[k], spec, mesh))
                   for k, spec in convert.flatten(specs).items()}
            for name, specs in (("params", pspecs), ("mu", ospecs["mu"]))}
    ranks = four[1]["shapes"][arch]
    assert sorted(tuple(r["coord"]) for r in ranks) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        assert r["params"] == want["params"]
        assert r["mu"] == want["mu"]
    # FSDP and ZeRO-1 do shard: some leaf of each is split over data
    flat_p = convert.flatten(pspecs)
    assert any("data" in s for s in flat_p.values())
    assert any("data" in s and "data" not in flat_p[k]
               for k, s in convert.flatten(ospecs["mu"]).items())


@pytest.mark.parametrize("option", ["int8", "master"])
def test_sharded_step_options_match_one_device(two, option):
    """int8 gradient compression with error feedback, and bf16 params with
    fp32 masters, on (2, 1): 3 steps' losses as the one-device step's."""
    np.testing.assert_allclose(two[0][f"options/{option}/mesh"],
                               two[0][f"options/{option}/one"], rtol=1e-4)


# ---------------------------------------------------------------------------
# (d) the MoE's expert-parallel branch
# ---------------------------------------------------------------------------

MOE_MESHES = ["2x2", "1x2", "1x4"]


def _moe(four, two, key):
    npz = two[0] if key.split("/")[2] == "1x2" else four[0]
    return npz[f"{key}/y"], npz[f"{key}/aux"]


@pytest.mark.parametrize("mesh", MOE_MESHES)
@pytest.mark.parametrize("case", JR.MOE_CASES)
def test_moe_expert_parallel_matches_reference(four, two, ref, case, mesh):
    key = f"moe/{case}/{mesh}"
    y, aux = _moe(four, two, key)
    want_y, want_aux = ref[f"{key}/y"], ref[f"{key}/aux"]
    scale = np.abs(want_y).max()
    assert np.abs(y - want_y).max() <= 1e-5 * scale
    np.testing.assert_allclose(aux, want_aux, rtol=1e-5)
    meta = (two if mesh == "1x2" else four)[1]
    assert meta["moe_ep"][key]             # the EP branch ran


@pytest.mark.parametrize("case", JR.MOE_CASES)
def test_moe_capacity_per_data_shard_is_copied(four, ref, case):
    """At capacity_factor 1.25 on (2, 2) the reference's EP branch counts
    capacity per data shard and averages the shards' aux losses, so it
    differs from its no-mesh branch; the port's differs at the same rows
    (ROADMAP C, a quirk copied). On (1, 2) and (1, 4) both equal."""
    npz = four[0]
    ref_rows = np.abs(ref[f"moe/{case}/2x2/y"] - ref[f"moe/{case}/none/y"]
                      ).max(-1) > 1e-4
    got_rows = np.abs(npz[f"moe/{case}/2x2/y"] - npz[f"moe/{case}/none/y"]
                      ).max(-1) > 1e-4
    np.testing.assert_array_equal(got_rows, ref_rows)
    assert ref[f"moe/{case}/2x2/aux"] != ref[f"moe/{case}/none/aux"]
    np.testing.assert_allclose(npz[f"moe/{case}/none/y"],
                               ref[f"moe/{case}/none/y"], rtol=1e-5,
                               atol=1e-5 * np.abs(ref[f"moe/{case}/none/y"]
                                                  ).max())
    np.testing.assert_allclose(npz[f"moe/{case}/1x4/y"],
                               npz[f"moe/{case}/none/y"], rtol=1e-5,
                               atol=1e-5 * np.abs(npz[f"moe/{case}/none/y"]
                                                  ).max())


# ---------------------------------------------------------------------------
# (e) sharded prefill and serving on (1, 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["prefill", "decode"])
@pytest.mark.parametrize("arch", TR.SERVE_ARCHS)
def test_sharded_serving_matches_one_device(two, arch, what):
    got = two[0][f"serve/{arch}/mesh/{what}"]
    want = two[0][f"serve/{arch}/one/{what}"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * (want.max() - want.min())


@pytest.mark.parametrize("arch", TR.SERVE_ARCHS + tuple(TR.DRIVER_CASES))
def test_sharded_serving_driver_gives_the_same_tokens(four, two, arch):
    """The driver on (1, 2) for each of SERVE_ARCHS; and where the slots'
    caches shard their sequence (``DRIVER_CASES``): olmo-1b on (2, 1) at 4
    slots (over a model axis of 1), at 1 (over data) and at 4 under
    "resident" (the batch replicated, the sequence over data), zamba2-7b's
    shared block on (2, 2) at 1 slot (over data, its heads over model)."""
    case = TR.DRIVER_CASES.get(arch)
    npz = four[0] if case is not None and case[1] == (2, 2) else two[0]
    np.testing.assert_array_equal(npz[f"serve/{arch}/mesh/tokens"],
                                  npz[f"serve/{arch}/one/tokens"])


# ---------------------------------------------------------------------------
# (f) restore across meshes, supervision on a mesh
# ---------------------------------------------------------------------------

def test_restore_saved_on_four_ranks_onto_two(four, two):
    saved = _grads(four[0], "saved")
    mesh = make_abstract_mesh((1, 2), ("data", "model"))
    for r, meta in enumerate(two[1]["restored"]):
        assert meta["step"] == 3
        assert tuple(meta["coord"]) == (0, r)
        for k, spec in meta["specs"].items():
            got = two[0][f"restored/{r}/{k}"]
            if not spec or not got.ndim:
                np.testing.assert_array_equal(got, saved[k])
                continue
            spec = tuple(tuple(e) if isinstance(e, list) else e
                         for e in spec)
            assert list(got.shape) == list(S.local_shape(
                saved[k].shape, spec, mesh))
            want = saved[k]
            for i, e in enumerate(spec):
                if e == "model":
                    want = np.split(want, 2, axis=i)[r]
            np.testing.assert_array_equal(got, want, err_msg=k)


def test_restore_saved_on_four_ranks_onto_one_device(four, outdir):
    saved = _grads(four[0], "saved")
    cfg = get_arch("olmo-1b").reduced()
    params = M.init_params(cfg, 0, device="cpu")
    template = {"params": params,
                "opt": TS.make_opt_state(params, TS.TrainConfig())}
    ckpt = CheckpointManager(AcaiProject("mesh", outdir / "lake"), "mesh")
    state, step = ckpt.restore(template)
    assert step == 3
    flat = convert.flatten(state)
    assert set(flat) == set(saved)
    for k, t in flat.items():
        np.testing.assert_array_equal(t.numpy(), saved[k], err_msg=k)


def test_supervised_run_on_a_mesh_resumes_to_the_unbroken_run(two):
    meta = two[1]["supervised"]
    assert meta["broken"]["restarts"] == 1
    assert meta["unbroken"]["restarts"] == 0
    assert meta["broken"]["final_step"] == meta["unbroken"]["final_step"] == 5
    broken = _grads(two[0], "sup/broken")
    unbroken = _grads(two[0], "sup/unbroken")
    assert set(broken) == set(unbroken) and broken
    for k in broken:
        np.testing.assert_array_equal(broken[k], unbroken[k], err_msg=k)
