"""Decode states whose KV sequence shards over the mesh.

- **Kernel level.** The decode kernel's partial softmax (``return_lse``:
  fp32 o and each row's log-sum-exp) on 1, 2 and 4 pieces of a cache,
  merged by ``spmd.merge_pieces`` (the pure core of ``merge_partials``),
  against the whole cache's plain version, the reference's
  ``decode_attention_ref`` and the Pallas kernel in interpret mode, with
  rows whose valid positions end inside a piece, at a piece's edge and in
  the first piece only.
- **The sharded serve step** of every ``jax_mesh_reference.KVSEQ_CASES``
  case (the sequence over model, over data and over data x model; a (2, 1)
  mesh; a rank's query columns splitting a head; the VLM; the "resident"
  layout) on gloo CPU ranks (``tests/torch_mesh_ranks.py``'s ``kv4`` and
  ``kv2``), held against the reference's serve step jitted with
  ``decode_state_specs`` on ``AxisType.Auto`` meshes (one JAX process on 4
  forced host devices): each tick's logits, the caches after the ticks,
  each rank's shard shapes, the decode launches at a shard's positions,
  and no collective of a tick as large as one layer's cache shard.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.sharding import make_abstract_mesh  # noqa: E402
from repro_torch.sharding import rules as SR  # noqa: E402
from repro_torch.sharding import spmd as S  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import jax_mesh_reference as JR  # noqa: E402
import torch_mesh_ranks as TR  # noqa: E402

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
SPAWN_TIMEOUT = 300
# the reference's cases in two processes of about equal compile time
REF_SPLIT = (("zamba2-7b@2x2/1", "qwen3-8b@2x2/4", "olmo-1b@2x1/4",
              "qwen3-8b-resident@2x2/4"),
             ("llama-3.2-vision-11b@1x2/4", "qwen3-8b@2x2/1",
              "olmo-1b@2x2/1", "qwen3-8b-10h@1x4/4"))
REF_TIMEOUT = 300
CASES = sorted(JR.KVSEQ_CASES)
# fp32 kernel pieces: the merge and the whole cache sum in other orders
PIECE_TOL = dict(rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# kernel level: partial softmaxes of pieces, merged
# ---------------------------------------------------------------------------

# B, S, H, KV, D (GQA 4:1) and cache_len: ending inside a piece (37), at a
# piece's edge (32, 48), in the first piece only (9), the whole buffer (64)
PIECE_SHAPE = (5, 64, 8, 2, 32)
PIECE_LENS = (37, 32, 9, 64, 48)


def _piece_inputs():
    b, s, h, kv, d = PIECE_SHAPE
    rng = np.random.default_rng(20)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, h, d), (b, kv, s, d), (b, kv, s, d)))
    return q, k, v, np.asarray(PIECE_LENS, np.int32)


def _merged(q, k, v, lens, pieces):
    """The plain version's partial softmax on each piece of the sequence,
    merged."""
    s = k.shape[2]
    n = s // pieces
    parts = []
    for j in range(pieces):
        part_lens = torch.from_numpy(np.clip(lens - j * n, 0, n))
        parts.append(dec.decode_attention_plain(
            torch.from_numpy(q), torch.from_numpy(k[:, :, j * n:(j + 1) * n]),
            torch.from_numpy(v[:, :, j * n:(j + 1) * n]), part_lens,
            return_lse=True))
    return S.merge_pieces(parts), parts


@pytest.mark.parametrize("pieces", [1, 2, 4])
def test_merged_pieces_match_whole_cache(pieces):
    q, k, v, lens = _piece_inputs()
    (o, lse), parts = _merged(q, k, v, lens, pieces)
    assert o.dtype == torch.float32 and lse.shape == PIECE_SHAPE[:1] + \
        PIECE_SHAPE[2:3]
    whole = dec.decode_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                       torch.from_numpy(lens))
    np.testing.assert_allclose(o.numpy(), whole.numpy(), **PIECE_TOL)
    _, whole_lse = dec.decode_attention_plain(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(lens),
        return_lse=True)
    np.testing.assert_allclose(lse.numpy(), whole_lse.numpy(), **PIECE_TOL)
    jl = jnp.asarray(lens)
    np.testing.assert_allclose(
        o.numpy(), np.asarray(jref.decode_attention_ref(q, k, v, jl)),
        **PIECE_TOL)
    pallas = jops.decode_attention(
        jnp.asarray(q)[:, None], jnp.swapaxes(jnp.asarray(k), 1, 2),
        jnp.swapaxes(jnp.asarray(v), 1, 2), jl, block_k=16, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(pallas)[:, 0],
                               **PIECE_TOL)
    if pieces == 4:       # row 2's 9 positions lie in the first piece only
        for o_j, lse_j in parts[1:]:
            assert torch.all(o_j[2] == 0)
            assert torch.all(torch.isneginf(lse_j[2]))


def test_pieces_that_hold_no_row_merge_to_zeros():
    """A row that no piece holds merges to zeros and -inf, with no NaN
    (exp(-inf - -inf) is never taken); an empty piece beside a full one
    leaves the full one's result as it is."""
    q, k, v, _ = _piece_inputs()
    lens = np.zeros(PIECE_SHAPE[0], np.int32)
    lens[0] = 12                      # in the first piece of 16 only
    (o, lse), parts = _merged(q, k, v, lens, 4)
    assert torch.all(o[1:] == 0) and torch.all(torch.isneginf(lse[1:]))
    assert torch.isfinite(o).all()
    np.testing.assert_array_equal(o[0].numpy(), parts[0][0][0].numpy())


def test_partial_softmax_of_bf16_is_fp32_and_rounds_to_the_output():
    """With return_lse a bf16 call's o is fp32, not rounded: rounded to
    bf16 it is the call's own output, bit for bit."""
    q, k, v, lens = (torch.from_numpy(a) for a in _piece_inputs())
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    o, lse = dec.decode_attention_bhd(q, k, v, lens, return_lse=True)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    assert torch.equal(o.to(torch.bfloat16),
                       dec.decode_attention_bhd(q, k, v, lens))


def test_shard_insert_writes_only_positions_in_the_shard():
    """``cache_insert(mode="shard")``: a row whose position lies outside
    the shard (before it, past it) keeps its values; the others take the
    new token at their position."""
    cache = torch.arange(3 * 8 * 2 * 4, dtype=torch.float32).reshape(
        3, 8, 2, 4)
    before = cache.clone()
    new = -torch.ones(3, 1, 2, 4)
    B.cache_insert(cache, new, torch.tensor([-3, 5, 8]), mode="shard")
    assert torch.equal(cache[0], before[0]) and torch.equal(cache[2],
                                                            before[2])
    assert torch.equal(cache[1, 5], new[1, 0])
    rest = torch.ones(8, dtype=torch.bool)
    rest[5] = False
    assert torch.equal(cache[1, rest], before[1, rest])


# ---------------------------------------------------------------------------
# the sharded serve step against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def outdir(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh_kvseq")


@pytest.fixture(scope="module")
def ref_path(outdir):
    """The reference's ``kvseq`` part in two JAX processes at once, their
    outputs merged into one npz."""
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = [subprocess.Popen(
        [sys.executable, str(TESTS / "jax_mesh_reference.py"),
         str(outdir / f"ref{i}.npz"), "kvseq=" + ",".join(cases)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True) for i, cases in enumerate(REF_SPLIT)]
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
def kv4(ref_path, outdir):
    return TR.spawn("kv4", 4, outdir, ref_path, SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def kv2(kv4, ref_path, outdir):
    return TR.spawn("kv2", 2, outdir, ref_path, SPAWN_TIMEOUT)


def _axes(entry) -> tuple:
    return () if entry is None else entry if isinstance(entry, tuple) \
        else (entry,)


def _run(kv4, kv2, case):
    shape = JR.KVSEQ_CASES[case][1]
    return kv4 if shape[0] * shape[1] == 4 else kv2


def _specs(case):
    _, shape, b, layout, _ = JR.KVSEQ_CASES[case]
    cfg = JR.kvseq_config(case, get_arch)
    mesh = make_abstract_mesh(shape, ("data", "model"))
    return cfg, mesh, SR.decode_state_specs(
        cfg, b, SR.AxisRules.for_mesh(mesh), layout=layout)


def test_every_case_shards_the_kv_sequence_but_on_a_model_axis_of_one():
    """The cases cover the sequence over model, over data and over
    data x model; on (2, 1) at batch 4 the spec names a model axis of 1."""
    seen = set()
    for case in CASES:
        cfg, mesh, specs = _specs(case)
        entry = specs[T.kv_cache_keys(cfg)[0]][0][-3]
        sizes = dict(mesh.shape)
        seen.add(tuple(a for a in _axes(entry) if sizes[a] > 1))
    assert seen == {("model",), ("data",), ("data", "model"), ()}


@pytest.mark.parametrize("case", CASES)
def test_sharded_decode_logits_match_reference(kv4, kv2, ref, case):
    """fp32, each of the ticks within 1e-5 of the reference's range."""
    got = _run(kv4, kv2, case)[0][f"kv/{case}/logits"]
    want = ref[f"kv/{case}/logits"]
    assert got.shape == want.shape == (JR.KV_TICKS,
                                       JR.KVSEQ_CASES[case][2],
                                       get_arch(JR.KVSEQ_CASES[case][0])
                                       .reduced().vocab_size)
    for t in range(JR.KV_TICKS):
        span = want[t].max() - want[t].min()
        assert np.abs(got[t] - want[t]).max() <= 1e-5 * span, t


@pytest.mark.parametrize("case", CASES)
def test_caches_after_the_ticks_match_reference(kv4, kv2, ref, case):
    """Every KV cache after the ticks, gathered with ``spmd.full_tensor``
    (a sequence dim over ("data", "model") included), within 1e-6 of the
    reference's state's range: the writes that crossed a shard's edge
    landed on the rank that holds their position, and nowhere else."""
    npz = _run(kv4, kv2, case)[0]
    cfg = JR.kvseq_config(case, get_arch)
    for key in T.kv_cache_keys(cfg):
        for i in range(2):
            got = npz[f"kv/{case}/state/{key}/{i}"]
            want = ref[f"kv/{case}/state/{key}/{i}"]
            assert got.shape == want.shape
            span = want.max() - want.min()
            assert np.abs(got - want).max() <= 1e-6 * span, (key, i)
            if f"layers/{key}" not in T.unused_subtrees(cfg):
                # the ticks wrote (the VLM's placeholder trailing cache,
                # with no trailing layer, is never written)
                assert (ref[f"kv/{case}/state0/{key}/{i}"] != want).any()


@pytest.mark.parametrize("case", CASES)
def test_local_caches_have_the_specs_shapes(kv4, kv2, ref, case):
    """Each rank holds its shard of every KV cache under the spec."""
    _, mesh, specs = _specs(case)
    ranks = _run(kv4, kv2, case)[1]["kvseq"][case]
    assert len({tuple(r["coord"]) for r in ranks}) == len(ranks)
    for r in ranks:
        for name, local in r["local"].items():
            key, i = name.split("/")
            full = ref[f"kv/{case}/state0/{name}"].shape
            assert local == list(S.local_shape(full, specs[key][int(i)],
                                               mesh)), name


@pytest.mark.parametrize("case", CASES)
def test_decode_runs_over_a_ranks_shard(kv4, kv2, case):
    """Each decode launch reads this rank's positions of the buffer."""
    cfg, mesh, specs = _specs(case)
    entry = specs[T.kv_cache_keys(cfg)[0]][0][-3]
    shards = 1
    for a in _axes(entry):
        shards *= dict(mesh.shape)[a]
    for r in _run(kv4, kv2, case)[1]["kvseq"][case]:
        assert r["cache_lens"] == [JR.KV_BUF // shards]


@pytest.mark.parametrize("case", CASES)
def test_no_tick_collective_carries_a_cache_shard(kv4, kv2, case):
    """Every collective of a tick (but the FSDP params' gather) moves less
    than one layer's cache shard: the ranks exchange their partial
    softmaxes, (B, H, D + 1) floats a layer, never their caches."""
    for r in _run(kv4, kv2, case)[1]["kvseq"][case]:
        assert 0 < r["most_moved"] < r["layer_shard"], r


@pytest.mark.parametrize("case", CASES)
def test_the_watch_sees_a_cache_gathered_either_way(kv4, kv2, case):
    """``spmd.watch_collectives`` sees a stack of caches gathered through
    ``spmd.full_tensor`` and through DTensor's own ``full_tensor``, each at
    least one layer's cache shard: a tick that gathered a cache either way
    would fail ``test_no_tick_collective_carries_a_cache_shard``."""
    for r in _run(kv4, kv2, case)[1]["kvseq"][case]:
        assert min(r["gathers_seen"]) >= r["layer_shard"], r
