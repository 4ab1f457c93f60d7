"""The port's blocks and model against ``repro.models`` on the same inputs and
converted weights (reduced olmo-1b, qwen3-8b, qwen3-32b, mistral-nemo-12b,
rwkv6-7b, zamba2-7b, and the MoE configs' fp32 logits, on the CPU; the MoE
block itself is in test_torch_moe.py)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_arch  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import mamba as JMa  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import rwkv as JR  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_arch as port_arch  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import mamba as Ma  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import rwkv as R  # noqa: E402

ARCHS = ["olmo-1b", "qwen3-8b"]
# the dense configs copied with the MoE family (GQA 8:1 at full size)
DENSE_MORE = ["qwen3-32b", "mistral-nemo-12b"]
# the MoE family; its bf16 logits follow the rule in test_torch_moe.py
MOE = ["olmoe-1b-7b", "llama4-scout-17b-a16e"]
# the VLM and audio families; their blocks, logits and serving are in
# test_torch_vlm_audio.py
MEDIA = ["llama-3.2-vision-11b", "musicgen-large"]
# the VLM's cross-attention K/V projections, which cast_params keeps fp32
CROSS_KV = ("layers/single/attn/wk", "layers/single/attn/wv")
# the recurrent families; "@7" runs zamba2 with 7 layers (2 periods of
# 2 mamba + shared attention, then 1 trailing mamba layer)
RECURRENT = ["rwkv6-7b", "zamba2-7b", "zamba2-7b@7"]
# leaves the reference initialises to zero; the tests give them seeded
# values in both packages, so that u and the decay and shift LoRAs matter
ZERO_INIT = ("bonus_u", "shift_lora_b", "decay_lora_b")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# elementwise blocks: fp32 agrees to rounding; bf16 to one or two ulps of
# values of order 1 (2**-8 relative)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _pair(rng, shape, dtype="float32", scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x):
    return np.asarray(x.float()) if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _exercise(tree, rng):
    return {k: _exercise(v, rng) if isinstance(v, dict)
            else (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
            if k in ZERO_INIT else v for k, v in tree.items()}


def _params(arch):
    """Reduced config of ``arch`` ("name" or "name@n_layers") in both
    packages, the reference's params with its zero-initialised leaves
    seeded, and the same params converted for the port."""
    name, _, layers = arch.partition("@")
    cfg, tcfg = get_arch(name).reduced(), port_arch(name).reduced()
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=int(layers))
        tcfg = dataclasses.replace(tcfg, n_layers=int(layers))
    params = _exercise(jax.tree.map(np.asarray, JM.init_params(
        cfg, jax.random.PRNGKey(0))), np.random.default_rng(9))
    return cfg, tcfg, jax.tree.map(jnp.asarray, params), \
        convert.from_numpy(params)


# ---------------------------------------------------------------------------
# norms, RoPE, MLP, cache insert
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["olmo-nonparam-ln", "qwen3-rmsnorm",
                                  "param-layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm(case, dtype):
    rng = np.random.default_rng(0)
    cfg = get_arch("olmo-1b" if case.startswith("olmo") else "qwen3-8b")
    if case == "param-layernorm":
        cfg = dataclasses.replace(cfg, parametric_norm=True,
                                  norm_type="layernorm")
    cfg = cfg.reduced()
    tcfg = port_arch(cfg.name[:-len("-smoke")])
    tcfg = dataclasses.replace(tcfg, parametric_norm=cfg.parametric_norm,
                               norm_type=cfg.norm_type).reduced()
    jx, tx = _pair(rng, (2, 5, cfg.d_model), dtype, scale=3.0)
    if not cfg.parametric_norm:
        jp, tp = {"_np": jnp.zeros((0,))}, {"_np": torch.zeros(0)}
    else:
        js, ts = _pair(rng, (cfg.d_model,))
        jp, tp = {"scale": js}, {"scale": ts}
        if cfg.norm_type == "layernorm":
            jb, tb = _pair(rng, (cfg.d_model,))
            jp["bias"], tp["bias"] = jb, tb
    got = B.apply_norm(tp, tx, tcfg)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(JB.apply_norm(jp, jx, cfg)),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_head_norm(dtype):
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng, (2, 5, 4, 16), dtype, scale=2.0)
    js, ts = _pair(rng, (16,), dtype)
    np.testing.assert_allclose(_np(B.rms_head_norm(tx, ts)),
                               _np(JB.rms_head_norm(jx, js)), **TOL[dtype])


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_table(theta):
    jc, js = JB.rope_table(40, 16, theta)
    tc, ts = B.rope_table(40, 16, theta)
    np.testing.assert_allclose(_np(tc), _np(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ts), _np(js), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_token", [False, True])
def test_apply_rope(dtype, per_token):
    """Half-split RoPE with cos/sin rounded to x's dtype before the products,
    for a (S, half) table and for per-token (B, 1, half) decode positions."""
    rng = np.random.default_rng(2)
    b, s = (3, 1) if per_token else (2, 7)
    jx, tx = _pair(rng, (b, s, 4, 16), dtype, scale=2.0)
    rows = 32 if per_token else s
    jc, js = JB.rope_table(rows, 16, 1e4)
    tc, ts = B.rope_table(rows, 16, 1e4)
    if per_token:
        pos = np.array([[0], [5], [31]])
        jc, js = jnp.take(jc, pos, axis=0), jnp.take(js, pos, axis=0)
        tc, ts = tc[torch.from_numpy(pos)], ts[torch.from_numpy(pos)]
    got = B.apply_rope(tx, tc, ts)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(JB.apply_rope(jx, jc, js)),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_block(dtype):
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng, (2, 5, 32), dtype)
    jp, tp = {}, {}
    for name, shape in (("w_gate", (32, 64)), ("w_up", (32, 64)),
                        ("w_down", (64, 32))):
        jp[name], tp[name] = _pair(rng, shape, scale=0.2)
    np.testing.assert_allclose(_np(B.mlp_block(tp, tx)),
                               _np(JB.mlp_block(jp, jx)), **TOL[dtype])


@pytest.mark.parametrize("mode", ["onehot", "scatter"])
def test_cache_insert_matches_reference(mode, monkeypatch):
    monkeypatch.setattr(JB, "CACHE_INSERT_IMPL", mode)
    rng = np.random.default_rng(4)
    jc, tc = _pair(rng, (3, 8, 2, 4))
    jn, tn = _pair(rng, (3, 1, 2, 4))
    idx = np.array([0, 5, 7], np.int32)
    want = JB._cache_insert(jc, jn, jnp.asarray(idx))
    got = B.cache_insert(tc, tn, torch.from_numpy(idx), mode=mode)
    assert got is tc                                  # written in place
    np.testing.assert_array_equal(_np(got), _np(want))


def test_cache_insert_out_of_range():
    """onehot drops an index past the cache, as the reference does; scatter
    raises on the CPU rather than writing anywhere."""
    cache = torch.zeros(2, 4, 1, 2)
    new = torch.ones(2, 1, 1, 2)
    B.cache_insert(cache, new, torch.tensor([1, 4]), mode="onehot")
    assert cache[0, 1].eq(1).all() and cache[1].eq(0).all()
    with pytest.raises(IndexError):
        B.cache_insert(cache, new, torch.tensor([1, 4]), mode="scatter")


def test_make_ctx_rejects_position_past_rope_table():
    cfg = port_arch("olmo-1b").reduced()
    M.make_ctx(cfg, 8, "decode", cache_len=torch.tensor([0, 7]), device="cpu")
    with pytest.raises(IndexError):
        M.make_ctx(cfg, 8, "decode", cache_len=torch.tensor([0, 8]),
                   device="cpu")


# ---------------------------------------------------------------------------
# attention block and the whole model
# ---------------------------------------------------------------------------


def _layer0_params(jp, tp):
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tl = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    return jl, tl


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_block_prefill(arch):
    cfg, tcfg, jp, tp = _params(arch)
    jl, tl = _layer0_params(jp, tp)
    jx, tx = _pair(np.random.default_rng(5), (2, 9, cfg.d_model))
    rope_j = JB.rope_table(9, 16, cfg.rope_theta)
    rope_t = B.rope_table(9, 16, cfg.rope_theta)
    want, _ = JB.attention_block(jl, jx, cfg, rope=rope_j)
    got, cache = B.attention_block(tl, tx, tcfg, rope=rope_t)
    assert cache is None
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_block_decode(arch):
    """Insert at cache_len, then attend over cache_len + 1 positions, with
    RoPE at positions cache_len from a table of buffer_len rows."""
    cfg, tcfg, jp, tp = _params(arch)
    jl, tl = _layer0_params(jp, tp)
    rng = np.random.default_rng(6)
    b, buf = 3, 10
    jx, tx = _pair(rng, (b, 1, cfg.d_model))
    shape = (b, buf, cfg.n_kv_heads, 16)
    jk, tk = _pair(rng, shape)
    jv, tv = _pair(rng, shape)
    lens = np.array([0, 4, 9], np.int32)
    want, (wk, wv) = JB.attention_block(
        jl, jx, cfg, rope=JB.rope_table(buf, 16, cfg.rope_theta),
        positions=jnp.asarray(lens)[:, None], kv_cache=(jk, jv),
        cache_len=jnp.asarray(lens))
    tl_len = torch.from_numpy(lens)
    got, (gk, gv) = B.attention_block(
        tl, tx, tcfg, rope=B.rope_table(buf, 16, cfg.rope_theta),
        positions=tl_len[:, None].long(), kv_cache=(tk, tv), cache_len=tl_len)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(gk), _np(wk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(gv), _np(wv), rtol=1e-5, atol=1e-5)


def _forward_pair(arch, dtype):
    cfg, tcfg, jp, tp = _params(arch)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 12))
    jd, td = DTYPES[dtype]
    ctx = JM.make_ctx(cfg, 12, "train", remat=None, compute_dtype=jd)
    want, _, _ = JM.forward(jp, jnp.asarray(toks), cfg, ctx)
    tctx = M.make_ctx(tcfg, 12, "prefill", compute_dtype=td, device="cpu")
    got, _, _ = M.forward(tp, torch.from_numpy(toks), tcfg, tctx)
    assert got.shape == want.shape and got.dtype == td
    return _np(got), _np(want)


@pytest.mark.parametrize("arch", ARCHS + DENSE_MORE + RECURRENT + MOE)
def test_forward_logits_fp32(arch):
    got, want = _forward_pair(arch, "float32")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS + DENSE_MORE + RECURRENT)
def test_forward_logits_bf16(arch):
    """bf16: both frameworks round activations to 8 bits of mantissa, at
    places that differ (XLA fuses elementwise chains in fp32; PyTorch rounds
    each op; the reference rounds attention probabilities to bf16, the
    flash kernel does not). Rounding error scales with the values rounded,
    and JAX's own bf16 logits sit 0.06-0.09 from its fp32 ones on qwen3's
    untied head (logits up to ~4). So the two bf16 runs must agree within
    5e-2 of the logits' range, and the port's bf16 error against JAX's fp32
    logits may be at most 1.5x JAX's own."""
    got, want = _forward_pair(arch, "bfloat16")
    _, fp32 = _forward_pair(arch, "float32")
    assert np.abs(got - fp32).max() <= 1.5 * np.abs(want - fp32).max()
    if arch == "rwkv6-7b":
        # reduced RWKV-6 in bf16 is noisy in both packages: JAX's own bf16
        # logits sit 1.43 from its fp32 ones (range 3.8), the port's 1.54,
        # so two bf16 runs cannot agree within 5e-2 of the range; the bound
        # above (at most 1.5x JAX's own bf16 error) is what holds
        return
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-2 * np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS + MOE + MEDIA)
def test_cast_params_keeps_norms_fp32(arch):
    """Norms (and the VLM's tanh gates and cross-attention K/V
    projections) stay fp32; every other leaf, the codebook embedding and
    head included, is cast."""
    _, tcfg, _, tp = _params(arch)
    cast = convert.flatten(M.cast_params(tp, torch.bfloat16))
    for key, val in cast.items():
        keep = key.split("/")[0] == "final_norm" or "/ln" in key \
            or key.split("/")[-1] in ("gate_attn", "gate_mlp") \
            or key in CROSS_KV
        assert val.dtype == (torch.float32 if keep else torch.bfloat16), key


def test_cast_params_keeps_fp32_read_leaves():
    """The leaves the reference reads in fp32 stay fp32 at load: norms, the
    RWKV bonus u, decay base and group-norm scale, the Mamba A_log, D,
    dt_bias and gated-norm scale (the bonus and A_log would lose bits in
    bf16), the VLM's tanh gates and its cross-attention K/V projections
    (the decode state multiplies the fp32 vision states by them).
    Everything else is cast."""
    fp32 = {"bonus_u", "decay_base", "ln_x", "A_log", "D", "dt_bias",
            "gate_norm", "scale", "_np", "bias", "gate_attn", "gate_mlp"}
    for arch in ARCHS + RECURRENT[:2] + MEDIA:
        params = M.init_params(port_arch(arch).reduced(), 0, device="cpu")
        params["final_norm"]["scale"] = torch.full((64,), 1.1)
        before = convert.flatten(params)      # the leaves before the cast
        for key, val in convert.flatten(M.cast_params(params,
                                                      torch.bfloat16)).items():
            leaf = key.split("/")[-1]
            keep = leaf in fp32 or key in CROSS_KV
            want = torch.float32 if keep else torch.bfloat16
            assert val.dtype == want, (arch, key)
            if keep:
                assert torch.equal(val, before[key]), key


def test_rwkv_shift_lora_init_scale_follows_reference():
    """The reference's _dense_init takes fan_in = shape[0], which is 5 for
    shift_lora_a's (5, d, lora) shape: its scale is 1/sqrt(5), not
    1/sqrt(d). The port copies that (ROADMAP C, quirk)."""
    cfg = port_arch("rwkv6-7b").reduced()
    tm = M.init_params(cfg, 0, device="cpu")["layers"]["tm"]
    assert abs(tm["shift_lora_a"].std().item() * 5 ** 0.5 - 1) < 0.05
    assert abs(tm["decay_lora_a"].std().item() * cfg.d_model ** 0.5 - 1) < 0.1
    for key in ZERO_INIT:
        assert not tm[key].any(), key


def test_mamba_out_proj_init_reuses_z_proj_key():
    """The reference's init_mamba_layer draws out_proj from z_proj's key
    (ks[1] twice): out_proj holds z_proj's values in the same flat order,
    scaled by 1/sqrt(d_inner) in place of 1/sqrt(d). The port copies that
    (ROADMAP C, quirk), in every stacked layer."""
    cfg = port_arch("zamba2-7b").reduced()
    d, di = cfg.d_model, cfg.mamba.d_inner(cfg.d_model)
    jax_layers = JM.init_params(get_arch("zamba2-7b").reduced(),
                                jax.random.PRNGKey(0))["layers"]
    port_layers = M.init_params(cfg, 0, device="cpu")["layers"]
    for group in ("inner", "trailing"):
        for m in (jax_layers[group]["m"], port_layers[group]["m"]):
            z, o = _np(m["z_proj"]), _np(m["out_proj"])
            assert o.shape == (*z.shape[:-2], di, d)
            np.testing.assert_allclose(o.reshape(z.shape) * np.sqrt(di / d),
                                       z, rtol=1e-6, atol=1e-6)
    out = port_layers["inner"]["m"]["out_proj"]
    assert abs(out.std().item() * di ** 0.5 - 1) < 0.1


# ---------------------------------------------------------------------------
# RWKV-6 and Mamba-2 sub-blocks
# ---------------------------------------------------------------------------


def _rwkv_layer():
    cfg, tcfg, jp, tp = _params("rwkv6-7b")
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["tm"])
    tl = {k: v[0] for k, v in tp["layers"]["tm"].items()}
    return cfg, tcfg, jl, tl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_ddlerp_decay_group_norm(dtype):
    cfg, tcfg, jl, tl = _rwkv_layer()
    rng = np.random.default_rng(10)
    jx, tx = _pair(rng, (2, 5, cfg.d_model), dtype)
    jxs, txs = _pair(rng, (2, 5, cfg.d_model), dtype)
    for got, want in zip(R._ddlerp(tl, tx, txs), JR._ddlerp(jl, jx, jxs)):
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    got = R._decay(tl, tx)
    assert got.dtype == torch.float32 and bool((got <= 0).all())
    np.testing.assert_allclose(_np(got), _np(JR._decay(jl, jx)), **TOL[dtype])
    jy, ty = _pair(rng, (2, 5, cfg.d_model), dtype, scale=3.0)
    np.testing.assert_allclose(
        _np(R._group_norm_heads(ty, tl["ln_x"].float(), 4)),
        _np(JR._group_norm_heads(jy, jl["ln_x"], 4)), **TOL[dtype])


def test_rwkv_time_and_channel_mix_prefill_and_decode():
    cfg, tcfg, jl, tl = _rwkv_layer()
    rng = np.random.default_rng(11)
    jx, tx = _pair(rng, (2, 20, cfg.d_model))
    want, _ = JR.rwkv_time_mix(jl, jx, cfg)
    got, state = R.rwkv_time_mix(tl, tx, tcfg)
    assert state is None
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(R.rwkv_channel_mix(tl, tx)),
                               _np(JR.rwkv_channel_mix(jl, jx)),
                               rtol=1e-5, atol=1e-5)
    # one decode token from a non-zero state and last token
    h = cfg.d_model // cfg.rwkv.head_dim
    jst, tst = _pair(rng, (2, h, 16, 16))
    jlast, tlast = _pair(rng, (2, 1, cfg.d_model))
    want, wst = JR.rwkv_time_mix(jl, jx[:, :1], cfg, state=jst, last_x=jlast)
    got, gst = R.rwkv_time_mix(tl, tx[:, :1], tcfg, state=tst, last_x=tlast)
    assert gst is tst                                   # updated in place
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(gst), _np(wst), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(R.rwkv_channel_mix(tl, tx[:, :1], last_x=tlast)),
        _np(JR.rwkv_channel_mix(jl, jx[:, :1], last_x=jlast)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv(with_state, dtype):
    rng = np.random.default_rng(12)
    jx, tx = _pair(rng, (2, 1 if with_state else 9, 24), dtype)
    jw, tw = _pair(rng, (4, 24), scale=0.3)
    jb, tb = _pair(rng, (24,), scale=0.1)
    js, ts = _pair(rng, (2, 3, 24), dtype) if with_state else (None, None)
    want, wst = JMa._causal_conv(jx, jw, jb, js)
    got, gst = Ma._causal_conv(tx, tw, tb, ts)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    np.testing.assert_array_equal(_np(gst), _np(wst))


@pytest.mark.parametrize("s", [1, 2])
def test_causal_conv_short_prefill(s):
    """A prefill shorter than the conv's W - 1 = 3 taps. The reference pads
    with zeros_like(x[:, :W-1]), only S rows: at S = 1 its output is empty,
    at S = 2 the taps are misaligned. The port pads W - 1 rows, so its
    prefill equals feeding the tokens one at a time from a zero state."""
    rng = np.random.default_rng(15)
    jx, tx = _pair(rng, (2, s, 24))
    jw, tw = _pair(rng, (4, 24), scale=0.3)
    jb, tb = _pair(rng, (24,), scale=0.1)
    got, gst = Ma._causal_conv(tx, tw, tb)
    state, steps = torch.zeros(2, 3, 24), []
    for t in range(s):
        y, state = Ma._causal_conv(tx[:, t:t + 1], tw, tb, state)
        steps.append(y)
    np.testing.assert_allclose(_np(got), _np(torch.cat(steps, 1)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_np(gst), _np(state))
    want, _ = JMa._causal_conv(jx, jw, jb)
    assert want.shape != got.shape or \
        not np.allclose(_np(want), _np(got), rtol=1e-3, atol=1e-3)


def _mamba_layer():
    cfg, tcfg, jp, tp = _params("zamba2-7b")
    jl = jax.tree.map(lambda a: a[0, 0], jp["layers"]["inner"]["m"])
    tl = {k: v[0, 0] for k, v in tp["layers"]["inner"]["m"].items()}
    return cfg, tcfg, jl, tl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_prefill(dtype):
    cfg, tcfg, jl, tl = _mamba_layer()
    jx, tx = _pair(np.random.default_rng(13), (2, 40, cfg.d_model), dtype)
    want, _ = JMa.mamba_block(jl, jx, cfg)
    got, state = Ma.mamba_block(tl, tx, tcfg)
    assert state is None and got.dtype == tx.dtype
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" \
        else dict(rtol=0, atol=5e-2 * float(np.abs(_np(want)).max()))
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_mamba_block_decode_updates_states_in_place():
    cfg, tcfg, jl, tl = _mamba_layer()
    rng = np.random.default_rng(14)
    mc = cfg.mamba
    nh, di = mc.n_heads(cfg.d_model), mc.d_inner(cfg.d_model)
    jx, tx = _pair(rng, (2, 1, cfg.d_model))
    jssm, tssm = _pair(rng, (2, nh, mc.d_state, mc.head_dim))
    jconv, tconv = _pair(rng, (2, mc.d_conv - 1, di + 2 * mc.d_state))
    want, (wssm, wconv) = JMa.mamba_block(jl, jx, cfg, state=(jssm, jconv))
    got, (gssm, gconv) = Ma.mamba_block(tl, tx, tcfg, state=(tssm, tconv))
    assert gssm is tssm and gconv is tconv
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(gssm), _np(wssm), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(gconv), _np(wconv), rtol=1e-6, atol=1e-6)
