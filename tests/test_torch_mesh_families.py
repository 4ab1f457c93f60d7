"""The recurrent, hybrid, VLM and audio layouts on a mesh: reduced
rwkv6-7b, zamba2-7b, llama-3.2-vision-11b and musicgen-large on gloo CPU
ranks, held against the reference's sharded steps (one JAX process on 4
forced host devices, ``tests/jax_mesh_reference.py``'s ``families`` part,
meshes of ``AxisType.Auto`` axes) and against the port's one-device path;
with zamba2-7b on (1, 4), where the decode conv state's shards (40
channels a rank) do not follow a rank's 32 x columns, and qwen3-8b at 10
heads of 16 on (1, 4), where a rank's 40 query columns split a head.

One spawn of 4 ranks and one of 2 serve every case
(``tests/torch_mesh_ranks.py``'s ``fam4`` and ``fam2``); the zero-init
leaves are seeded in both packages (``jax_mesh_reference.seeded``), so
that every gradient is non-zero and a replicated leaf whose gradient a
rank holds only in part shows.
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
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.sharding import make_abstract_mesh  # noqa: E402
from repro_torch.sharding import spmd as S  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import jax_mesh_reference as JR  # noqa: E402
import torch_mesh_ranks as TR  # noqa: E402

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
SPAWN_TIMEOUT = 300
# the reference's cases in two processes of about equal compile time, and
# their time limit (a hang guard: on a loaded machine one process of all
# six cases took over 300 s)
REF_SPLIT = (("zamba2-7b", "musicgen-large", "qwen3-8b-10h@1x4"),
             ("rwkv6-7b", "llama-3.2-vision-11b", "zamba2-7b@1x4"))
REF_TIMEOUT = 600
# fp32 gradients: the partitioner and the ranks sum in other orders
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# rwkv6-7b's fp32 gradients carry about 5e-5 of each leaf's largest entry
# of rounding (its per-head group norm; ROADMAP C, "Slice 9")
RWKV_GRAD_ATOL = 2e-4


@pytest.fixture(scope="module")
def outdir(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh_families")


@pytest.fixture(scope="module")
def ref_path(outdir):
    """The reference's ``families`` part in two JAX processes at once (its
    compiles take about 2 minutes in one, more on a loaded machine), their
    outputs merged into one npz."""
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = []
    for i, cases in enumerate(REF_SPLIT):
        procs.append(subprocess.Popen(
            [sys.executable, str(TESTS / "jax_mesh_reference.py"),
             str(outdir / f"ref{i}.npz"), "families=" + ",".join(cases)],
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
    path = outdir / "ref.npz"
    merged = {}
    for i in range(len(REF_SPLIT)):
        with np.load(outdir / f"ref{i}.npz") as part:
            merged.update({k: part[k] for k in part.files})
    np.savez(path, **merged)
    return path


@pytest.fixture(scope="module")
def ref(ref_path):
    return np.load(ref_path)


@pytest.fixture(scope="module")
def fam4(ref_path, outdir):
    return TR.spawn("fam4", 4, outdir, ref_path, SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def fam2(fam4, ref_path, outdir):
    return TR.spawn("fam2", 2, outdir, ref_path, SPAWN_TIMEOUT)


def _tree(npz, prefix):
    n = len(prefix) + 1
    return {k[n:]: npz[k] for k in npz.files if k.startswith(prefix + "/")}


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(JR.FAMILY_CASES))
def test_sharded_loss_and_grads_match_reference(fam4, ref, case):
    """Every case on its mesh: (2, 2) for the four families, (1, 4) for
    zamba2-7b and for qwen3-8b at 10 heads (2.5 heads a rank)."""
    got = fam4[0]
    np.testing.assert_allclose(got[f"fam/{case}/loss"],
                               ref[f"fam/{case}/loss"], **GRAD_TOL)
    want = _tree(ref, f"fam/{case}/grad")
    mine = _tree(got, f"fam/{case}/grad")
    assert set(mine) == set(want)
    rwkv = JR.FAMILY_CASES[case][0] == "rwkv6-7b"
    unused = tuple(f"{path}/" for path in
                   T.unused_subtrees(JR.family_config(case, get_arch)))
    for k in want:
        # every leaf that the layout runs takes part
        assert k.startswith(unused) or np.abs(want[k]).max() > 0, k
        if rwkv:
            assert np.abs(mine[k] - want[k]).max() \
                <= RWKV_GRAD_ATOL * np.abs(want[k]).max(), k
        else:
            np.testing.assert_allclose(mine[k], want[k], err_msg=k,
                                       **GRAD_TOL)


@pytest.mark.parametrize("arch", JR.FAMILY_ARCHS)
def test_three_sharded_steps_match_reference(fam4, ref, arch):
    """Losses, not params (ROADMAP C, "Slice 14": AdamW's first update
    moves a weight whose tiny gradient flips sign by 2 lr)."""
    np.testing.assert_allclose(fam4[0][f"fam/{arch}/steps"],
                               ref[f"fam/{arch}/steps"], rtol=1e-4)


@pytest.mark.parametrize("arch", JR.FAMILY_ARCHS)
def test_local_shards_have_the_specs_shapes(fam4, arch):
    cfg = JR.family_config(arch, get_arch)
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    _, pspecs, ospecs = TS.sharded_specs(cfg, mesh)
    shapes = convert.flatten(M.param_shapes(cfg))
    want = {name: {k: list(S.local_shape(shapes[k], spec, mesh))
                   for k, spec in convert.flatten(specs).items()}
            for name, specs in (("params", pspecs), ("mu", ospecs["mu"]))}
    ranks = fam4[1]["shapes"][arch]
    assert sorted(tuple(r["coord"]) for r in ranks) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        assert r["params"] == want["params"]
        assert r["mu"] == want["mu"]
    # the family's own leaves split over the model axis
    flat = convert.flatten(pspecs)
    own = {"rwkv6-7b": ("layers/tm/wr", "layers/tm/ln_x", "layers/tm/cm_wv"),
           "zamba2-7b": ("layers/inner/m/x_proj", "layers/inner/m/gate_norm",
                         "layers/inner/m/out_proj"),
           "llama-3.2-vision-11b": ("layers/single/attn/wk",
                                    "layers/single/mlp/w_down"),
           "musicgen-large": ("embed", "lm_head")}[arch]
    for k in own:
        assert "model" in flat[k], k


# ---------------------------------------------------------------------------
# sharded prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", JR.FAMILY_ARCHS)
def test_sharded_prefill_matches_reference(fam2, ref, arch):
    """fp32 on (1, 2) against the reference's prefill jitted with
    ``build_cell``'s specs on a (1, 2) mesh; the VLM with its vision
    states, musicgen-large on (B, S, K) frames."""
    got, want = fam2[0][f"fam/{arch}/prefill"], ref[f"fam/{arch}/prefill"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **GRAD_TOL)


SERVING = [("qwen3-8b-10h@1x4", "prefill"), ("zamba2-7b@1x4", "prefill"),
           ("zamba2-7b@1x4", "decode"), ("llama-3.2-vision-11b", "prefill"),
           ("llama-3.2-vision-11b", "decode"), ("musicgen-large", "prefill"),
           ("musicgen-large", "decode")]


@pytest.mark.parametrize("key,what", SERVING)
def test_sharded_serving_matches_one_device(fam4, fam2, key, what):
    """fp32 prefill and teacher-forced decode over every position against
    the one-device port: the (1, 4) cases of ``fam4``, the VLM (at 2 kv
    heads: its reduced config's one kv head on a model axis of 2 shards
    the KV sequence, ROADMAP A11b.2) and musicgen-large on (1, 2)."""
    npz = fam4[0] if key.endswith("@1x4") else fam2[0]
    got = npz[f"serve/{key}/mesh/{what}"]
    want = npz[f"serve/{key}/one/{what}"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * (want.max() - want.min())


HEADS = {"prefill/rwkv6-7b": {"wkv6": [2]},
         "prefill/zamba2-7b": {"mamba2_ssd": [4], "flash_attention": [2]},
         "prefill/llama-3.2-vision-11b": {"flash_attention": [2]},
         "prefill/musicgen-large": {"flash_attention": [2]},
         "llama-3.2-vision-11b": {"flash_attention": [2],
                                  "decode_attention": [2]},
         "musicgen-large": {"flash_attention": [2], "decode_attention": [2]},
         "qwen3-8b-10h@1x4": {"flash_attention": [3]},
         "zamba2-7b@1x4": {"mamba2_ssd": [2], "flash_attention": [1],
                           "decode_attention": [1]}}


@pytest.mark.parametrize("key", sorted(HEADS))
def test_kernels_run_at_a_ranks_heads(fam4, fam2, key):
    """Each kernel wrapper is called at this rank's heads only: WKV6 at 2
    of 4, SSD at 4 of 8 on (1, 2) and 2 of 8 on (1, 4), attention at a
    rank's query heads (qwen3-8b's 10 heads on 4 ranks: the 3 whole heads
    that a rank's 2.5 heads of columns touch)."""
    meta = fam4[1] if key.endswith("@1x4") else fam2[1]
    assert meta["heads"][key] == HEADS[key]
