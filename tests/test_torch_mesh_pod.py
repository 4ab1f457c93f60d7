"""Meshes with a "pod" axis, microbatches on a mesh, and FSDP that gathers
one layer at a time.

- **Train** (``jax_mesh_reference.POD_CASES``): reduced olmo-1b and
  olmoe-1b-7b on (2, 2, 1) (the batch over "pod" x "data"; the MoE's
  no-mesh branch) and (2, 1, 2) (the MoE's expert-parallel branch, its
  capacity counted per pod shard), reduced qwen3-8b on (2, 2, 2) (8 ranks:
  the batch group is neither one axis nor the world): the loss and every
  gradient at ``GRAD_TOL``, and 3 steps' losses, against the reference's
  ``build_sharded_train`` on ``AxisType.Auto`` meshes.
- **Microbatches 2** on (2, 2) and (2, 1, 2): 3 steps' losses against the
  reference's (which splits the global batch's rows), and the sharded
  microbatched gradients against the port's one-device ones.
- **Serving** (``POD_SERVE_CASES``): the serve step where the KV sequence
  shards over ("pod", "data", "model") and the batch over ("pod",
  "data"), held as ``tests/test_torch_mesh_kvseq.py`` holds its cases; the
  sharded prefill on (2, 2, 1) against one device.
- **The per-layer gather**: in a (2, 2) train step under each remat policy
  and a (2, 2) serve tick of reduced olmo-1b, every FSDP gather is one
  layer's slice of a stacked leaf, never the stack, and under remat the
  backward's recompute gathers each layer again.

The reference runs in one JAX process per part of ``REF_SPLIT`` (4 forced
host devices; 8 for the 8-rank case), the port in one spawn of 4 gloo
ranks (``pod4``) and one of 8 (``pod8``), ``tests/torch_mesh_ranks.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.sharding import make_abstract_mesh  # noqa: E402
from repro_torch.sharding import rules as SR  # noqa: E402
from repro_torch.sharding import spmd as S  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import jax_mesh_reference as JR  # noqa: E402
import torch_mesh_ranks as TR  # noqa: E402

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
SPAWN_TIMEOUT = 300
REF_TIMEOUT = 300
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# the reference's cases in processes of about equal compile time: (forced
# host devices, cases)
REF_SPLIT = (
    (4, ("olmo-1b@2x2x1", "olmo-1b@2x1x2", "olmoe-1b-7b@2x2x1")),
    (4, ("olmoe-1b-7b@2x1x2", "olmo-1b@2x2/mb2", "olmo-1b@2x1x2/mb2")),
    (4, ("olmoe-1b-7b@2x2/mb2", "olmoe-1b-7b@2x1x2/mb2",
         *JR.POD_SERVE_CASES)),
    (8, ("qwen3-8b@2x2x2",)),
)
TRAIN = sorted(c for c, v in JR.POD_CASES.items() if v[2] == 1)
MICRO = sorted(c for c, v in JR.POD_CASES.items() if v[2] > 1)
SERVE = sorted(JR.POD_SERVE_CASES)


def _world(case) -> int:
    return int(np.prod({**JR.POD_CASES, **JR.POD_SERVE_CASES}[case][1]))


# ---------------------------------------------------------------------------
# the specs and the mesh context, no process group
# ---------------------------------------------------------------------------

def test_ref_split_covers_every_case():
    got = [c for _, cases in REF_SPLIT for c in cases]
    assert sorted(got) == sorted({**JR.POD_CASES, **JR.POD_SERVE_CASES})
    for n, cases in REF_SPLIT:
        assert all(_world(c) <= n for c in cases)


@pytest.mark.parametrize("case,entry", [
    ("qwen3-8b@2x1x2/1", (None, ("pod", "data", "model"), None, None)),
    ("olmo-1b@2x2x1/4", (("pod", "data"), "model", None, None)),
    ("qwen3-8b-resident@2x1x2/4", (None, ("pod", "data", "model"), None,
                                   None)),
    ("zamba2-7b@2x2x1/1", (None, ("pod", "data", "model"), None, None))])
def test_pod_serve_cases_take_the_references_cache_specs(case, entry):
    """Each case's first KV cache spec, as the reference's
    ``decode_state_specs`` gives it on the pod mesh (one stack dim)."""
    cfg = JR.kvseq_config(case, get_arch)
    _, shape, b, layout, _ = JR.POD_SERVE_CASES[case]
    rules = SR.AxisRules.for_mesh(make_abstract_mesh(shape, JR.mesh_axes(
        shape)))
    specs = SR.decode_state_specs(cfg, b, rules, layout=layout)
    assert specs[T.kv_cache_keys(cfg)[0]][0][-4:] == entry


def test_mesh_ctx_refuses_an_unknown_axis():
    with pytest.raises(ValueError, match="axes"):
        S.MeshCtx(make_abstract_mesh((2, 2), ("data", "seq")))


def test_parse_mesh_names_data_and_model_only():
    """``--mesh`` names ("data", "model"), as the reference's does; a pod
    mesh comes from ``make_mesh`` or ``make_production_mesh``."""
    assert LM.parse_mesh("2x4") == ((2, 4), ("data", "model"))
    with pytest.raises(ValueError):
        LM.parse_mesh("2x2x2")
    mesh = LM.make_production_mesh(multi_pod=True)
    assert (tuple(mesh.axis_names), dict(mesh.shape)) == (
        ("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16})
    assert tuple(LM.mesh_for_chips(1024).axis_names) == ("pod", "data",
                                                         "model")


# ---------------------------------------------------------------------------
# the reference and the ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def outdir(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh_pod")


@pytest.fixture(scope="module")
def ref_path(outdir):
    """The reference's ``pod`` part in one JAX process per REF_SPLIT entry,
    all at once, their outputs merged into one npz."""
    procs = []
    for i, (n, cases) in enumerate(REF_SPLIT):
        env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")
        procs.append(subprocess.Popen(
            [sys.executable, str(TESTS / "jax_mesh_reference.py"),
             str(outdir / f"ref{i}.npz"), "pod=" + ",".join(cases)],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True))
    try:
        errs = [p.communicate(timeout=REF_TIMEOUT)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    merged = {}
    for i in range(len(REF_SPLIT)):
        with np.load(outdir / f"ref{i}.npz") as part:
            merged.update({k: part[k] for k in part.files})
    path = outdir / "ref.npz"
    np.savez(path, **merged)
    return path


@pytest.fixture(scope="module")
def ref(ref_path):
    return np.load(ref_path)


@pytest.fixture(scope="module")
def pod4(ref_path, outdir):
    return TR.spawn("pod4", 4, outdir, ref_path, SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def pod8(pod4, ref_path, outdir):
    return TR.spawn("pod8", 8, outdir, ref_path, SPAWN_TIMEOUT)


def _run(pod4, pod8, case):
    return pod8 if _world(case) == 8 else pod4


def _tree(npz, prefix):
    n = len(prefix) + 1
    return {k[n:]: npz[k] for k in npz.files if k.startswith(prefix + "/")}


# ---------------------------------------------------------------------------
# train on pod meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", TRAIN)
def test_pod_loss_and_grads_match_reference(pod4, pod8, ref, case):
    got = _run(pod4, pod8, case)[0]
    np.testing.assert_allclose(got[f"pod/{case}/loss"],
                               ref[f"pod/{case}/loss"], **GRAD_TOL)
    want = _tree(ref, f"pod/{case}/grad")
    mine = _tree(got, f"pod/{case}/grad")
    assert set(mine) == set(want) and want
    for k in want:
        np.testing.assert_allclose(mine[k], want[k], err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("case", TRAIN + MICRO)
def test_three_pod_steps_match_reference(pod4, pod8, ref, case):
    """Losses of 3 AdamW steps; with microbatches, each step's loss is the
    last microbatch's over its global rows, as the reference reports it."""
    np.testing.assert_allclose(_run(pod4, pod8, case)[0][f"pod/{case}/steps"],
                               ref[f"pod/{case}/steps"], rtol=1e-4)


def test_moe_capacity_per_pod_shard_is_copied(pod4, ref):
    """On (2, 1, 2) the MoE's expert-parallel branch counts capacity per
    pod shard and on (2, 2, 1) its no-mesh branch over the global batch:
    their losses differ in the reference, and the port's with them."""
    a, b = "olmoe-1b-7b@2x2x1", "olmoe-1b-7b@2x1x2"
    assert abs(ref[f"pod/{a}/loss"] - ref[f"pod/{b}/loss"]) > 1e-3
    for case in (a, b):
        np.testing.assert_allclose(pod4[0][f"pod/{case}/loss"],
                                   ref[f"pod/{case}/loss"], rtol=1e-5)


@pytest.mark.parametrize("case", MICRO)
def test_microbatched_grads_match_one_device(pod4, case):
    """The sharded gradients of 2 microbatches (each rank its share of each
    global row block) against the one-device port's, which splits the same
    rows: olmo-1b as it is; olmoe-1b-7b at the no-drop capacity without
    the aux loss, where its expert-parallel branch and one device compute
    the same function (at its own capacity the steps above hold it to the
    reference)."""
    got = pod4[0]
    np.testing.assert_allclose(got[f"pod/{case}/mb_loss"],
                               got[f"pod/{case}/one_loss"], **GRAD_TOL)
    want = _tree(got, f"pod/{case}/one_grad")
    mine = _tree(got, f"pod/{case}/mb_grad")
    assert set(mine) == set(want) and want
    for k in want:
        np.testing.assert_allclose(mine[k], want[k], err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("case", TRAIN + MICRO)
def test_pod_local_shards_have_the_specs_shapes(pod4, pod8, case):
    """Every rank holds its shard of each param and moment: "pod"
    replicates both, ZeRO-1 shards the moments over "data" alone."""
    arch, shape, _ = JR.POD_CASES[case]
    cfg = get_arch(arch).reduced()
    mesh = make_abstract_mesh(shape, JR.mesh_axes(shape))
    _, pspecs, ospecs = TS.sharded_specs(cfg, mesh)
    shapes = convert.flatten(M.param_shapes(cfg))
    want = {name: {k: list(S.local_shape(shapes[k], spec, mesh))
                   for k, spec in convert.flatten(specs).items()}
            for name, specs in (("params", pspecs), ("mu", ospecs["mu"]))}
    ranks = _run(pod4, pod8, case)[1]["pod_shapes"][case]
    assert len({tuple(r["coord"]) for r in ranks}) == _world(case)
    for r in ranks:
        assert r["params"] == want["params"]
        assert r["mu"] == want["mu"]
    assert not any("pod" in str(s) for s in
                   convert.flatten(ospecs["mu"]).values())


def test_groups_are_made_once_a_mesh(pod8):
    """On (2, 2, 2) a new mesh makes its process groups at its first
    ``MeshCtx`` (every set of two or more axes: 2 groups each of ("pod",
    "data"), ("pod", "model") and ("data", "model"); the three axes take
    the world's), and no later ``MeshCtx`` makes one; the batch group of a
    rank holds the ranks of its model coordinate, pod major."""
    for rank, r in enumerate(pod8[1]["groups"]):
        assert r["first"] == 6 and r["again"] == 0, r
        m = rank % 2
        assert r["batch_ranks"] == [m, 2 + m, 4 + m, 6 + m]
        assert r["batch_rank"] == rank // 2


# ---------------------------------------------------------------------------
# serving on pod meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", SERVE)
def test_pod_decode_logits_match_reference(pod4, ref, case):
    """fp32, each of the ticks within 1e-5 of the reference's range."""
    got = pod4[0][f"kv/{case}/logits"]
    want = ref[f"kv/{case}/logits"]
    assert got.shape == want.shape
    for t in range(JR.KV_TICKS):
        span = want[t].max() - want[t].min()
        assert np.abs(got[t] - want[t]).max() <= 1e-5 * span, t


@pytest.mark.parametrize("case", SERVE)
def test_pod_caches_after_the_ticks_match_reference(pod4, ref, case):
    npz = pod4[0]
    cfg = JR.kvseq_config(case, get_arch)
    for key in T.kv_cache_keys(cfg):
        for i in range(2):
            got = npz[f"kv/{case}/state/{key}/{i}"]
            want = ref[f"kv/{case}/state/{key}/{i}"]
            assert got.shape == want.shape
            span = want.max() - want.min()
            assert np.abs(got - want).max() <= 1e-6 * span, (key, i)
            assert (ref[f"kv/{case}/state0/{key}/{i}"] != want).any()


@pytest.mark.parametrize("case", SERVE)
def test_pod_caches_shard_and_ticks_move_no_cache(pod4, ref, case):
    """Each rank holds its shard of every KV cache under the spec, each
    decode launch reads the rank's positions, and no collective of a tick
    (but FSDP's param gathers) is as large as one layer's cache shard."""
    cfg = JR.kvseq_config(case, get_arch)
    _, shape, b, layout, _ = JR.POD_SERVE_CASES[case]
    mesh = make_abstract_mesh(shape, JR.mesh_axes(shape))
    specs = SR.decode_state_specs(cfg, b, SR.AxisRules.for_mesh(mesh),
                                  layout=layout)
    entry = specs[T.kv_cache_keys(cfg)[0]][0][-3]
    shards = int(np.prod([dict(mesh.shape)[a] for a in
                          (entry if isinstance(entry, tuple) else
                           (entry,) if entry else ())]))
    ranks = pod4[1]["kvseq"][case]
    assert len({tuple(r["coord"]) for r in ranks}) == 4
    for r in ranks:
        for name, local in r["local"].items():
            key, i = name.split("/")
            full = ref[f"kv/{case}/state0/{name}"].shape
            assert local == list(S.local_shape(full, specs[key][int(i)],
                                               mesh)), name
        assert r["cache_lens"] == [JR.KV_BUF // shards]
        assert 0 < r["most_moved"] < r["layer_shard"], r


def test_pod_prefill_matches_one_device(pod4):
    got, want = pod4[0]["pod/prefill/mesh"], pod4[0]["pod/prefill/one"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * (want.max() - want.min())


# ---------------------------------------------------------------------------
# FSDP gathers one layer at a time
# ---------------------------------------------------------------------------

def _stacked(meta):
    """{leaf: (its global shape, a layer's slice of it as the gather gives
    it: whole over data, this rank's columns over model)} of the stacked
    leaves that FSDP shards, on (2, 2)."""
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    out = {}
    for k, shape in meta["shapes"].items():
        spec = [tuple(e) if isinstance(e, list) else e
                for e in meta["specs"][k]]
        if k.startswith("layers/") and "data" in str(spec):
            kept = tuple(None if e == "data" else e for e in spec)
            out[k] = (shape, list(S.local_shape(shape, kept, mesh))[1:])
    return out


@pytest.mark.parametrize("what", ["train/none", "train/full", "train/dots",
                                  "serve"])
def test_fsdp_gathers_one_layer_at_a_time(pod4, what):
    """Every param gather of a (2, 2) train step or serve tick is one
    layer's slice of a stacked leaf (its shape without the layer dim),
    never the stack; each such leaf is gathered once a layer in the
    forward and, under remat "full" or "dots", once more a layer in the
    backward's recompute (the gather sits inside the checkpointed layer,
    so no whole layer is kept from the forward to the backward), and the
    largest gather is one layer's largest leaf."""
    for r in pod4[1]["gathers"]:
        stacked = _stacked(r)
        assert stacked
        layer = sorted(v for _, v in stacked.values())
        seen = r[what]
        got = [s for s, _ in seen]
        assert all(s in layer for s in got), got
        assert not any(len(s) == len(v) for s in got
                       for v, _ in stacked.values())
        per_layer = 2 if what in ("train/full", "train/dots") else 1
        for shape in layer:
            assert got.count(shape) == per_layer * r["layers"] * \
                layer.count(shape), shape
        assert max(int(np.prod(s)) for s in got) == max(
            int(np.prod(s)) for s in layer)
        if what == "serve":
            assert not any(grad for _, grad in seen)
