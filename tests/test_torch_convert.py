"""Weight bridge: JAX params -> port tensors -> numpy is bit-exact, keeps the
checkpoint key paths, and the port's own init has the reference's
structure (every family: the VLM's ``layers/single`` with its stacked 0-d
gates, musicgen's (K, V, d) embedding included)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_arch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train.checkpoints import _flatten  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_arch as port_arch  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ARCHS = ["olmo-1b", "qwen3-8b", "rwkv6-7b", "zamba2-7b", "olmoe-1b-7b",
         "llama4-scout-17b-a16e", "llama-3.2-vision-11b", "musicgen-large"]


def _jax_params(arch):
    cfg = get_arch(arch).reduced()
    return jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("arch", ARCHS)
def test_round_trip_is_bit_exact(arch):
    ref = _jax_params(arch)
    back = convert.to_numpy(convert.from_numpy(ref))
    want, got = _flatten(ref), convert.flatten(back)
    assert list(got) == list(want)
    for key, a in want.items():
        b = got[key]
        assert b.shape == a.shape and b.dtype == a.dtype, key
        np.testing.assert_array_equal(b.view(np.uint32), a.view(np.uint32),
                                      err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_flatten_matches_checkpoint_keys(arch):
    ref = _jax_params(arch)
    tensors = convert.flatten(convert.from_numpy(ref))
    assert list(tensors) == list(_flatten(ref))
    assert all(isinstance(t, torch.Tensor) for t in tensors.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_has_reference_structure(arch):
    ref = _flatten(_jax_params(arch))
    ours = convert.flatten(M.init_params(port_arch(arch).reduced(), 0,
                                         device="cpu"))
    assert list(ours) == list(ref)
    for key, a in ref.items():
        assert tuple(ours[key].shape) == a.shape, key
        assert ours[key].dtype == torch.float32, key


def test_olmo_zero_size_norm_sentinel():
    ref = _jax_params("olmo-1b")
    tensors = convert.from_numpy(ref)
    flat = convert.flatten(tensors)
    cfg = get_arch("olmo-1b").reduced()
    assert tuple(flat["final_norm/_np"].shape) == (0,)
    assert tuple(flat["layers/ln1/_np"].shape) == (cfg.n_layers, 0)
    back = convert.flatten(convert.to_numpy(tensors))
    assert back["layers/ln2/_np"].shape == (cfg.n_layers, 0)
    assert back["layers/ln2/_np"].dtype == np.float32


def test_non_float32_leaf_is_refused():
    with pytest.raises(TypeError):
        convert.from_numpy({"w": np.zeros((2,), np.float16)})
    with pytest.raises(TypeError):
        convert.to_numpy({"w": torch.zeros(2, dtype=torch.bfloat16)})


@pytest.mark.parametrize("arch", ARCHS)
def test_seeded_init_is_reproducible(arch):
    cfg = port_arch(arch).reduced()
    a = convert.flatten(M.init_params(cfg, 3, device="cpu"))
    b = convert.flatten(M.init_params(cfg, 3, device="cpu"))
    c = convert.flatten(M.init_params(cfg, 4, device="cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])


def test_zamba2_periodic_structure_and_shared_block():
    """zamba2's params: inner layers stacked (periods, inner_n), trailing
    layers stacked (max(trailing, 1),), and one unstacked shared attention
    block used at every site, as in the reference."""
    cfg = get_arch("zamba2-7b").reduced()
    ref = _jax_params("zamba2-7b")
    tensors = convert.flatten(convert.from_numpy(ref))
    periods = cfg.n_layers // cfg.hybrid_attn_every
    inner_n = cfg.hybrid_attn_every - 1
    assert tensors["layers/inner/m/A_log"].shape[:2] == (periods, inner_n)
    assert tensors["layers/trailing/m/A_log"].shape[0] == 1
    assert tuple(tensors["shared_block/attn/wq"].shape) == (
        cfg.d_model, cfg.n_heads * cfg.resolved_head_dim)
    ours = M.init_params(port_arch("zamba2-7b").reduced(), 0, device="cpu")
    assert set(ours) == {"embed", "final_norm", "layers", "lm_head",
                         "shared_block"}
    assert tuple(ours["shared_block"]["ln1"]["scale"].shape) == (cfg.d_model,)


def test_moe_subtrees_round_trip():
    """The stacked ``moe`` subtree (router, experts) and llama4-scout's
    nested ``moe/shared`` MLP cross the bridge both ways, bit for bit, under
    the reference's checkpoint key paths."""
    ref = _jax_params("llama4-scout-17b-a16e")
    flat = convert.flatten(convert.from_numpy(ref))
    cfg = get_arch("llama4-scout-17b-a16e").reduced()
    m = cfg.moe
    assert tuple(flat["layers/moe/w_gate"].shape) == (
        cfg.n_layers, m.n_experts, cfg.d_model, m.d_ff_expert)
    assert tuple(flat["layers/moe/shared/w_down"].shape) == (
        cfg.n_layers, m.n_shared_experts * m.d_ff_shared, cfg.d_model)
    back = _flatten(convert.to_numpy(convert.from_numpy(ref)))
    for key in ("layers/moe/router", "layers/moe/shared/w_gate"):
        np.testing.assert_array_equal(back[key], _flatten(ref)[key])
