"""The port's VLM and audio families against the reference on the CPU:
reduced llama-3.2-vision-11b (2 periods of 2 dense layers and a
cross-attention layer, GQA 4:1, vision states of (8, 48)) and reduced
musicgen-large (4 dense layers over 4 codebooks). The reference's params
are converted through numpy, with the cross-attention layers' tanh gates
seeded in [0.5, 1.5] in both packages: at the reference's zero gates every
cross-attention layer adds nothing and the logits ignore the vision input.
Inputs come from seeded numpy."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_arch  # noqa: E402
from repro.core.acai import AcaiProject as RefProject  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import decode as JD  # noqa: E402
from repro.train import checkpoints as JC  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_arch as port_arch  # noqa: E402
from repro_torch.core.acai import AcaiProject  # noqa: E402
from repro_torch.launch import serve as L  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import decode as D  # noqa: E402
from repro_torch.train import checkpoints as C  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

VLM, AUDIO = "llama-3.2-vision-11b", "musicgen-large"
MEDIA = [VLM, AUDIO]
CPU = "cpu"
GATES = ("gate_attn", "gate_mlp")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# fp32 gradients: both frameworks sum the same products in other orders
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(x):
    return np.asarray(x.float()) if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _seed_gates(tree, rng):
    """The gates drawn uniform in [0.5, 1.5], every other leaf as it is."""
    return {k: _seed_gates(v, rng) if isinstance(v, dict)
            else rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            if k in GATES else v for k, v in tree.items()}


def _params(arch, gates=True, **replace):
    """Reduced config in both packages (fields replaced by ``replace``) and
    the reference's params as numpy, the VLM's gates seeded."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), **replace)
    tcfg = dataclasses.replace(port_arch(arch).reduced(), **replace)
    params = jax.tree.map(np.asarray, JM.init_params(cfg,
                                                     jax.random.PRNGKey(0)))
    if gates:
        params = _seed_gates(params, np.random.default_rng(9))
    return cfg, tcfg, params


def _inputs(cfg, seed, b, s):
    """tokens (B, S), or (B, S, K) with codebooks, and the VLM's vision
    states (B, Nv, d_src) in fp32, as the data pipeline makes them."""
    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
    out = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision"] = rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.vision_dim)).astype(np.float32)
    return out


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _forward(cfg, tcfg, params, inp, dtype):
    """Logits of the reference's forward and of the port's, as numpy."""
    jd, td = DTYPES[dtype]
    s = inp["tokens"].shape[1]
    vision = inp.get("vision")
    ctx = JM.make_ctx(cfg, s, "train", remat=None, compute_dtype=jd,
                      vision=None if vision is None else jnp.asarray(vision))
    want, _, _ = JM.forward(_j(params), jnp.asarray(inp["tokens"]), cfg, ctx)
    tctx = M.make_ctx(tcfg, s, "prefill", compute_dtype=td, device=CPU,
                      vision=None if vision is None
                      else torch.from_numpy(vision))
    got, _, _ = M.forward(convert.from_numpy(params),
                          torch.from_numpy(inp["tokens"]), tcfg, tctx)
    assert got.shape == want.shape and got.dtype == td
    return _np(got), _np(want)


def _decode_logits(tcfg, tp, inp, dtype=torch.float32):
    """The port's teacher-forced decode over every position: (B, S, ...)
    logits from the serve step, the VLM's vision K/V built from tp."""
    toks = torch.from_numpy(inp["tokens"])
    b, s = toks.shape[:2]
    vision = inp.get("vision")
    states = T.init_decode_state(tcfg, b, s, dtype=dtype, vision=vision,
                                 params=tp)
    step = D.make_serve_step(tcfg, s, compute_dtype=dtype, device=CPU)
    lens, outs = torch.zeros((b,), dtype=torch.int32), []
    for t in range(s):
        logits, states, _ = step(tp, states, {"tokens": toks[:, t:t + 1],
                                              "cache_len": lens})
        outs.append(logits)
        lens = lens + 1
    return torch.cat(outs, 1).numpy()


def _jax_decode_logits(cfg, jp, inp):
    """The reference's teacher-forced decode (fp32 compute and state)."""
    toks = inp["tokens"]
    b, s = toks.shape[:2]
    vision = None if "vision" not in inp else jnp.asarray(inp["vision"])
    states = JT.init_decode_state(cfg, b, s, dtype=jnp.float32,
                                  vision=vision, params=jp)
    step = jax.jit(JD.make_serve_step(cfg, s, compute_dtype=jnp.float32))
    lens, outs = jnp.zeros((b,), jnp.int32), []
    for t in range(s):
        batch = {"tokens": jnp.asarray(toks[:, t:t + 1]), "cache_len": lens}
        if vision is not None:
            batch["vision"] = vision
        logits, states, _ = step(jp, states, batch)
        outs.append(np.asarray(logits))
        lens = lens + 1
    return np.concatenate(outs, 1)


def _single(params, i=0):
    """Cross-attention layer i's params (numpy)."""
    return jax.tree.map(lambda a: a[i], params["layers"]["single"])


# ---------------------------------------------------------------------------
# layout and params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MEDIA)
def test_tree_matches_reference_init(arch):
    """The port's init_params has the reference's keys, shapes and dtypes:
    the VLM's stacked (P, I) dense layers, (P,) cross-attention layers
    with wk and wv of d_src rows and 0-d gates (stacked (P,)) at zero, and
    the placeholder trailing layer the reference keeps at trailing 0;
    musicgen's (K, V, d) embedding and (d, K V) head."""
    cfg = get_arch(arch).reduced()
    want = convert.flatten(jax.tree.map(np.asarray, JM.init_params(
        cfg, jax.random.PRNGKey(0))))
    got = convert.flatten(M.init_params(port_arch(arch).reduced(), 0,
                                        device=CPU))
    assert list(got) == list(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert got[key].dtype == torch.float32, key
    if arch == VLM:
        lay = T.build_layout(port_arch(arch).reduced())
        assert lay == JT.build_layout(cfg) == {
            "kind": "periodic", "periods": 2, "inner_n": 2,
            "inner_block": "dense", "single_block": "cross_attn",
            "trailing": 0}
        hd = cfg.resolved_head_dim
        assert tuple(got["layers/single/attn/wk"].shape) == (
            2, cfg.vision_dim, cfg.n_kv_heads * hd)
        assert tuple(got["layers/trailing/attn/wq"].shape)[0] == 1
        for gate in GATES:
            assert tuple(got[f"layers/single/{gate}"].shape) == (2,)
            assert not got[f"layers/single/{gate}"].any()
        assert T.unused_subtrees(port_arch(arch).reduced()) == (
            "layers/trailing",)
    else:
        k, v, d = cfg.n_codebooks, cfg.vocab_size, cfg.d_model
        assert tuple(got["embed"].shape) == (k, v, d)
        assert tuple(got["lm_head"].shape) == (d, k * v)
        assert T.unused_subtrees(port_arch(arch).reduced()) == ()


# ---------------------------------------------------------------------------
# the cross-attention block and its decode state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_block_matches_reference(dtype):
    """attention_block's kv_src branch (K and V from the vision states, no
    RoPE, no mask, grouped products for GQA 4:1) against the reference's
    on the same x and vision. fp32 within 1e-5; bf16 within 2e-2 of the
    output's range (each package rounds the projections, the scores'
    probabilities and the outputs to bf16)."""
    cfg, tcfg, params = _params(VLM)
    lp = _single(params)["attn"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    vis = rng.standard_normal((2, cfg.n_vision_tokens,
                               cfg.vision_dim)).astype(np.float32)
    jd, td = DTYPES[dtype]
    want, cache = JB.attention_block(_j(lp), jnp.asarray(x).astype(jd), cfg,
                                     kv_src=jnp.asarray(vis).astype(jd))
    got, tcache = B.attention_block(convert.from_numpy(lp),
                                    torch.from_numpy(x).to(td), tcfg,
                                    kv_src=torch.from_numpy(vis).to(td))
    assert cache is None and tcache is None and got.dtype == td
    scale = np.abs(_np(want)).max()
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol * scale)


def test_cross_attention_equals_expanded_heads():
    """The grouped products give the values of the reference's form on
    GQA-expanded K and V (fp32 scores, softmax, probabilities in v's
    dtype), in fp32 and bf16."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 5, 8, 16), (2, 7, 2, 16), (2, 7, 2, 16)))
    for dt in (torch.float32, torch.bfloat16):
        qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
        kq, vq = B._gqa_expand(kd, 8), B._gqa_expand(vd, 8)
        sc = torch.einsum("bqhd,bkhd->bhqk", qd.float(), kq.float()) / 4.0
        want = torch.einsum("bhqk,bkhd->bqhd",
                            torch.softmax(sc, -1).to(dt), vq)
        got = B.cross_attention(qd, kd, vd)
        assert got.dtype == dt
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-2 if dt == torch.bfloat16 else 1e-6)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_cross_attention_layer_matches_reference(mode):
    """The whole cross-attention layer (norms, attention, MLP, tanh gates)
    against the reference's layer_fwd, fp32: prefill projects the vision
    states; decode reads K/V from its state (seeded here), which it never
    writes."""
    cfg, tcfg, params = _params(VLM)
    lp = _single(params, 1)
    rng = np.random.default_rng(5)
    s = 9 if mode == "prefill" else 1
    x = rng.standard_normal((3, s, cfg.d_model)).astype(np.float32)
    if mode == "prefill":
        vis = rng.standard_normal((3, cfg.n_vision_tokens,
                                   cfg.vision_dim)).astype(np.float32)
        jst, tst = None, None
        jctx, tctx = ({"mode": mode, "vision": jnp.asarray(vis)},
                      {"mode": mode, "vision": torch.from_numpy(vis)})
    else:
        shape = (3, cfg.n_vision_tokens, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        kv = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
        jst, tst = tuple(map(jnp.asarray, kv)), tuple(map(torch.from_numpy,
                                                         kv))
        jctx, tctx = {"mode": mode}, {"mode": mode}
    want, jnew, _, _ = JT.layer_fwd("cross_attn", _j(lp), jnp.asarray(x),
                                    cfg, jctx, jst)
    got, tnew, aux = T.layer_fwd("cross_attn", convert.from_numpy(lp),
                                 torch.from_numpy(x), tcfg, tctx, tst)
    assert aux is None
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    if mode == "decode":
        assert tnew is tst
        for a, b in zip(tnew, kv):
            assert np.array_equal(a.numpy(), b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_state_matches_reference(dtype):
    """init_decode_state's vision K/V: per period, vision @ wk and vision @
    wv in the vision's fp32, cast to the state dtype, (P, B, Nv, KV, D);
    the attention caches zeroed as the reference's."""
    cfg, tcfg, params = _params(VLM)
    vis = np.random.default_rng(6).standard_normal(
        (2, cfg.n_vision_tokens, cfg.vision_dim)).astype(np.float32)
    jd, td = DTYPES[dtype]
    want = JT.init_decode_state(cfg, 2, 10, dtype=jd,
                                vision=jnp.asarray(vis), params=_j(params))
    got = T.init_decode_state(tcfg, 2, 10, dtype=td, vision=vis,
                              params=convert.from_numpy(params))
    assert set(got) == set(want) == {"inner", "single", "trailing"}
    for part in ("inner", "single", "trailing"):
        for g, w in zip(got[part], want[part]):
            assert tuple(g.shape) == w.shape and g.dtype == td, part
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-6)
    assert tuple(got["single"][0].shape) == (
        2, 2, cfg.n_vision_tokens, cfg.n_kv_heads, cfg.resolved_head_dim)
    with pytest.raises(ValueError, match="vision and params"):
        T.init_decode_state(tcfg, 2, 10)


def test_qk_norm_cross_state_fault_is_fixed_in_the_port():
    """With qk_norm on (no config sets it), the reference's prefill applies
    the k-norm to the vision K and its decode state does not, so its
    prefill and teacher-forced decode compute different functions. The
    port applies the k-norm in both, and they agree (fp32). ROADMAP C."""
    cfg, tcfg, params = _params(VLM, qk_norm=True)
    assert "k_norm" in params["layers"]["single"]["attn"]
    inp = _inputs(cfg, 7, 2, 8)
    got, want = _forward(cfg, tcfg, params, inp, "float32")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    ref_gap = np.abs(_jax_decode_logits(cfg, _j(params), inp) - want).max()
    assert ref_gap > 1e-2, ref_gap
    np.testing.assert_allclose(
        _decode_logits(tcfg, convert.from_numpy(params), inp), got,
        rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MEDIA)
def test_forward_logits_fp32(arch):
    """Logits (B, S, V) or (B, S, K, V) within the dense family's 1e-4."""
    cfg, tcfg, params = _params(arch)
    got, want = _forward(cfg, tcfg, params, _inputs(cfg, 7, 2, 12),
                         "float32")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", MEDIA)
def test_forward_logits_bf16(arch):
    """bf16 logits: within 5e-2 of the range of the reference's bf16
    logits, and the port's error against the reference's fp32 logits at
    most 1.5x the reference's own (test_torch_model's rule). musicgen's
    embedding is the reference's bf16 one-hot einsum: the table rounded to
    bf16, the sum over codebooks rounded once."""
    cfg, tcfg, params = _params(arch)
    inp = _inputs(cfg, 7, 2, 12)
    got, want = _forward(cfg, tcfg, params, inp, "bfloat16")
    _, fp32 = _forward(cfg, tcfg, params, inp, "float32")
    assert np.abs(got - fp32).max() <= 1.5 * np.abs(want - fp32).max()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-2 * np.abs(want).max())


def test_codebook_embedding_sums_rows_like_the_one_hot():
    """The gathered codebook rows summed equal the reference's one-hot
    einsum, in fp32 and in bf16 (bit for bit in bf16: one rounding of the
    fp32 sum of bf16 rows)."""
    cfg, tcfg, params = _params(AUDIO)
    toks = _inputs(cfg, 8, 3, 5)["tokens"]
    for dtype in ("float32", "bfloat16"):
        jd, td = DTYPES[dtype]
        want = JM.embed_tokens(_j(params), jnp.asarray(toks), cfg, jd)
        got = M.embed_tokens(convert.from_numpy(params),
                             torch.from_numpy(toks), tcfg, td)
        assert got.dtype == td and tuple(got.shape) == (3, 5, cfg.d_model)
        if dtype == "bfloat16":
            assert np.array_equal(_np(got), _np(want))
        else:
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                       atol=1e-7)


def test_logits_follow_the_vision_input_only_through_the_gates():
    """With seeded gates, other vision states move the logits in both
    packages; at the reference's zero gates the logits do not depend on
    the vision states at all."""
    cfg, tcfg, params = _params(VLM)
    inp = _inputs(cfg, 7, 2, 12)
    other = {**inp, "vision": _inputs(cfg, 8, 2, 12)["vision"]}
    got, want = _forward(cfg, tcfg, params, inp, "float32")
    got2, want2 = _forward(cfg, tcfg, params, other, "float32")
    assert np.abs(got2 - got).max() > 1e-2
    assert np.abs(want2 - want).max() > 1e-2
    cfg, tcfg, zero = _params(VLM, gates=False)
    assert not any(_single(zero)[g] for g in GATES)
    got, want = _forward(cfg, tcfg, zero, inp, "float32")
    got2, want2 = _forward(cfg, tcfg, zero, other, "float32")
    assert np.array_equal(got, got2) and np.array_equal(want, want2)


def test_cast_params_keeps_the_gates_fp32():
    """The reference takes tanh of the fp32 gate and builds the decode
    state's vision K/V from its fp32 wk and wv: cast_params leaves the
    gates, the cross-attention layers' wk and wv (and norms) fp32, bit for
    bit, and casts the rest."""
    _, tcfg, params = _params(VLM)
    tp = convert.from_numpy(params)
    flat = convert.flatten(tp)                # the leaves before the cast
    cast = convert.flatten(M.cast_params(tp, torch.bfloat16))
    cross_kv = ("layers/single/attn/wk", "layers/single/attn/wv")
    for key, val in cast.items():
        exact = key.split("/")[-1] in GATES or key in cross_kv
        keep = exact or "/ln" in key or key.startswith("final_norm")
        assert val.dtype == (torch.float32 if keep else torch.bfloat16), key
        if exact:
            assert torch.equal(val, flat[key])


def test_cast_params_casts_the_tree_in_place():
    """The tree itself takes the cast leaves (so each fp32 leaf can be
    freed as it is cast), with the values of each leaf's own cast."""
    _, tcfg, params = _params(VLM)
    tree = convert.from_numpy(params)
    want = {k: v if v.dtype == torch.float32 and (
        k.split("/")[-1] in GATES + ("scale",) or k.endswith(("/wk", "/wv"))
        and k.startswith("layers/single/")) else v.to(torch.bfloat16)
        for k, v in convert.flatten(tree).items()}
    single = tree["layers"]["single"]
    assert M.cast_params(tree, torch.bfloat16) is tree
    assert tree["layers"]["single"] is single
    got = convert.flatten(tree)
    assert got.keys() == want.keys()
    for key, val in got.items():
        assert val.dtype == want[key].dtype and torch.equal(val, want[key]), \
            key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_state_of_cast_params_matches_reference(dtype):
    """Serving loads bf16 weights (cast_params), and the decode state's
    vision K/V built from them equal the reference's, which multiplies the
    fp32 vision states by its fp32 wk and wv: in an fp32 state within
    1e-5 (bf16-rounded wk and wv would miss by about 1e-3 of the largest
    entry), in a bf16 state within one bf16 step of the largest entry."""
    cfg, tcfg, params = _params(VLM)
    vis = np.random.default_rng(6).standard_normal(
        (2, cfg.n_vision_tokens, cfg.vision_dim)).astype(np.float32)
    jd, td = DTYPES[dtype]
    want = JT.init_decode_state(cfg, 2, 10, dtype=jd,
                                vision=jnp.asarray(vis), params=_j(params))
    cast = M.cast_params(convert.from_numpy(params), torch.bfloat16)
    got = T.init_decode_state(tcfg, 2, 10, dtype=td, vision=vis,
                              params=cast)
    step = 1e-5 if dtype == "float32" else 2 ** -8
    for g, w in zip(got["single"], want["single"]):
        assert g.dtype == td
        np.testing.assert_allclose(_np(g), _np(w), rtol=0,
                                   atol=step * np.abs(_np(w)).max())


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MEDIA)
def test_prefill_step_matches_jax(arch, dtype):
    """The prefill step's last-position logits, (B, V) or (B, K, V), with
    vision in the batch, against the reference's prefill step: fp32 within
    1e-4, bf16 within 5e-2 of the range."""
    cfg, tcfg, params = _params(arch)
    inp = _inputs(cfg, 2, 3, 10)
    jd, td = DTYPES[dtype]
    want = np.asarray(JD.make_prefill_step(cfg, compute_dtype=jd)(
        _j(params), _j(inp)), np.float32)
    got = D.make_prefill_step(tcfg, compute_dtype=td, device=CPU)(
        convert.from_numpy(params), _t(inp))
    books = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    assert tuple(got.shape) == (3, *books, cfg.vocab_size) and got.dtype == td
    atol = 1e-4 if dtype == "float32" else 5e-2 * np.abs(want).max()
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=atol)


@pytest.mark.parametrize("arch", MEDIA)
def test_serve_step_matches_jax(arch):
    """Five fp32 serve steps on per-slot cache lengths: logits, next tokens
    ((B,) or (B, K)) and every state leaf (the vision K/V included) against
    the reference's serve step."""
    cfg, tcfg, params = _params(arch)
    b, buf = 3, 16
    vision = _inputs(cfg, 3, b, 1).get("vision")
    jp, tp = _j(params), convert.from_numpy(params)
    jst = JT.init_decode_state(cfg, b, buf, dtype=jnp.float32, params=jp,
                               vision=None if vision is None
                               else jnp.asarray(vision))
    tst = T.init_decode_state(tcfg, b, buf, dtype=torch.float32, params=tp,
                              vision=vision)
    jstep = jax.jit(JD.make_serve_step(cfg, buf, compute_dtype=jnp.float32))
    tstep = D.make_serve_step(tcfg, buf, compute_dtype=torch.float32,
                              device=CPU)
    lens = np.array([0, 3, 7], np.int32)
    for t in range(5):
        toks = _inputs(cfg, 10 + t, b, 1)["tokens"]
        batch = {"tokens": toks, "cache_len": lens}
        if vision is not None:
            batch["vision"] = vision
        jl, jst, jn = jstep(jp, jst, _j(batch))
        tl, tst, tn = tstep(tp, tst, _t(batch))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        assert tuple(tn.shape) == np.asarray(jn).shape
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        lens = lens + 1
    for part in sorted(jst):
        for jc, tc in zip(jax.tree.leaves(jst[part]),
                          jax.tree.leaves(tst[part])):
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc),
                                       rtol=1e-5, atol=1e-5)


def _jax_greedy_fp32(cfg, params, prompt, max_new, vision):
    """repro.serve.decode.greedy_generate's loop with fp32 compute and
    state (the reference function fixes both to bf16)."""
    b = prompt.shape[0]
    buf = prompt.shape[1] + max_new
    states = JT.init_decode_state(cfg, b, buf, dtype=jnp.float32,
                                  vision=vision, params=params)
    step = jax.jit(JD.make_serve_step(cfg, buf, compute_dtype=jnp.float32))
    cache_len = jnp.zeros((b,), jnp.int32)
    cur, out = prompt[:, :1], []
    for i in range(buf - 1):
        batch = {"tokens": cur, "cache_len": cache_len}
        if vision is not None:
            batch["vision"] = vision
        _, states, nxt = step(params, states, batch)
        cache_len = cache_len + 1
        if i + 1 < prompt.shape[1]:
            cur = prompt[:, i + 1:i + 2]
        else:
            cur = nxt[:, None] if nxt.ndim == 1 else nxt[:, None, :]
            out.append(cur)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch", MEDIA)
def test_greedy_generate_matches_jax_fp32(arch):
    """fp32 greedy tokens, (B, new) or (B, new, K), equal to the
    reference's, with vision and with codebooks."""
    cfg, tcfg, params = _params(arch)
    inp = _inputs(cfg, 4, 2, 5)
    vision = inp.get("vision")
    want = _jax_greedy_fp32(cfg, _j(params), jnp.asarray(inp["tokens"]), 6,
                            None if vision is None else jnp.asarray(vision))
    got = D.greedy_generate(tcfg, convert.from_numpy(params),
                            torch.from_numpy(inp["tokens"]), 6,
                            vision=vision, compute_dtype=torch.float32,
                            device=CPU)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", MEDIA)
def test_decode_matches_prefill_forward(arch):
    """Teacher-forced decode (the VLM's vision K/V from its state) equals
    the parallel forward at every position, fp32."""
    cfg, tcfg, params = _params(arch)
    inp = _inputs(cfg, 1, 2, 12)
    got, _ = _forward(cfg, tcfg, params, inp, "float32")
    np.testing.assert_allclose(
        _decode_logits(tcfg, convert.from_numpy(params), inp), got,
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", MEDIA)
def test_serving_driver_refuses_media_archs(arch, monkeypatch):
    """serve() and the demo driver refuse the VLM and the codebook archs,
    as the reference's driver does."""
    tcfg = port_arch(arch).reduced()
    with pytest.raises(ValueError, match="token-only"):
        L.serve(tcfg, {}, [[1, 2]], slots=1, buf=8, max_new=1, device=CPU)
    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch, "--device",
                                     "cpu"])
    with pytest.raises(SystemExit, match="token-only archs"):
        L.main()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _pipe(cfg, b=4, s=16):
    return JP.TokenPipeline(JP.DataConfig(vocab_size=32, seq_len=s,
                                          global_batch=b, markov_temp=2.5),
                            cfg)


@pytest.mark.parametrize("arch", MEDIA)
def test_loss_and_grads_match_jax(arch):
    """fp32 loss and every gradient leaf against jax.value_and_grad of the
    reference's loss, on the pipeline's batch (vision states; code frames
    with np.roll labels); the placeholder trailing layer's gradients are
    zeros in both."""
    cfg, tcfg, params = _params(arch)
    batch = _pipe(cfg).batch_at(0)
    jtc = JTS.TrainConfig(remat="none", compute_dtype="float32")
    (jl, _), jg = jax.jit(jax.value_and_grad(
        JTS.make_loss_fn(cfg, jtc), has_aux=True))(_j(params), _j(batch))
    tl, _, tg = TS.make_grad_fn(tcfg, TS.TrainConfig(
        remat="full", compute_dtype="float32"), device=CPU)(
        convert.from_numpy(params), _t(batch))
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    got = convert.flatten(tg)
    want = convert.flatten(jax.tree.map(np.asarray, jg))
    assert list(got) == list(want)
    for key, w in want.items():
        np.testing.assert_allclose(_np(got[key]), w, err_msg=key, **GRAD_TOL)
    if arch == VLM:
        assert np.abs(want["layers/single/gate_attn"]).min() > 0
        trailing = [k for k in got if k.startswith("layers/trailing/")]
        assert trailing and all(not got[k].any() and not want[k].any()
                                for k in trailing)


def test_train_step_matches_reference_after_3_steps_with_microbatches():
    """The VLM, 3 AdamW steps (lr 1e-3, fp32, microbatches 2: vision splits
    with the rows): params and moments against the reference's, with
    test_torch_train's multi-step tolerances (a param within 6 lr, all but
    1e-3 of the entries within 1e-5; moments at the gradients')."""
    cfg, tcfg, params = _params(VLM)
    tkw = dict(remat="full", compute_dtype="float32", microbatches=2)
    okw = dict(lr=1e-3, warmup_steps=0, total_steps=100, weight_decay=0.1)
    jtc, ttc = JTS.TrainConfig(**tkw), TS.TrainConfig(**tkw)
    jstep = jax.jit(JTS.make_train_step(cfg, jtc, JO.OptimizerConfig(**okw)))
    tstep = TS.make_train_step(tcfg, ttc, O.OptimizerConfig(**okw),
                               device=CPU)
    jp, tp = _j(params), convert.from_numpy(params)
    js, ts = JTS.make_opt_state(jp, jtc), TS.make_opt_state(tp, ttc)
    pipe = _pipe(cfg)
    for i in range(3):
        batch = pipe.batch_at(i)
        assert batch["vision"].shape[0] == 4
        jp, js, jm = jstep(jp, js, _j(batch))
        tp, ts, tm = tstep(tp, ts, batch)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
    got = convert.flatten(tp)
    for key, w in convert.flatten(jax.tree.map(np.asarray, jp)).items():
        err = np.abs(_np(got[key]) - w)
        assert err.max(initial=0) <= 6e-3, key
        assert (err > 1e-5).mean() <= 1e-3, key
    for part in ("mu", "nu"):
        got = convert.flatten(ts[part])
        for key, w in convert.flatten(jax.tree.map(np.asarray,
                                                   js[part])).items():
            np.testing.assert_allclose(_np(got[key]), w, err_msg=key,
                                       **GRAD_TOL)


@pytest.mark.parametrize("arch", MEDIA)
def test_remat_policies_give_equal_grads(arch):
    """remat none, full and dots (the cross-attention layers outside the
    checkpoint) give gradients within 1e-6 of each leaf's largest entry."""
    cfg, tcfg, params = _params(arch)
    batch = _t(_pipe(cfg, b=2, s=24).batch_at(1))
    tp = convert.from_numpy(params)
    out = {}
    for remat in ("none", "full", "dots"):
        out[remat] = convert.flatten(TS.make_grad_fn(tcfg, TS.TrainConfig(
            remat=remat, compute_dtype="float32"), device=CPU)(tp, batch)[2])
    for remat in ("full", "dots"):
        for key, want in out["none"].items():
            np.testing.assert_allclose(
                _np(out[remat][key]), _np(want), rtol=0,
                err_msg=f"{remat} {key}",
                atol=1e-6 * float(want.abs().max()) if want.numel() else 0)


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
@pytest.mark.parametrize("arch", MEDIA)
def test_checkpoints_restore_across_packages(tmp_path, arch, writer):
    """Params and optimizer state after one reference step (the VLM's
    stacked gates, layers/single, the placeholder trailing layer;
    musicgen's (K, V, d) embedding) saved by one package restore bit for
    bit in the other."""
    cfg, _, params = _params(arch)
    tc = JTS.TrainConfig(remat="none")
    jp, js, _ = jax.jit(JTS.make_train_step(cfg, tc, JO.OptimizerConfig()))(
        _j(params), JTS.make_opt_state(_j(params), tc),
        _j(_pipe(cfg, b=2).batch_at(0)))
    params, opt = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
    port = {"params": convert.from_numpy(params),
            "opt": convert.opt_state_from_numpy(opt)}
    if writer == "repro":
        JC.CheckpointManager(RefProject("p", tmp_path), "run").save(
            1, jp, js, extra={"loss": 2.5})
        state, step = C.CheckpointManager(AcaiProject("p", tmp_path),
                                          "run").restore(
            O.tree_map(torch.empty_like, port))
        got = convert.flatten(state)
        want = convert.flatten(port)
    else:
        C.CheckpointManager(AcaiProject("p", tmp_path), "run").save(
            1, port["params"], port["opt"], extra={"loss": 2.5})
        state, step = JC.CheckpointManager(RefProject("p", tmp_path),
                                           "run").restore(
            {"params": jp, "opt": js})
        got = convert.flatten(jax.tree.map(np.asarray, state))
        want = convert.flatten({"params": params, "opt": opt})
    assert step == 1 and list(got) == list(want)
    for key, w in want.items():
        g, w = (np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)
                for t in (got[key], w))
        assert g.shape == w.shape and g.dtype == w.dtype, key
        assert g.tobytes() == w.tobytes(), key
    if arch == VLM:
        assert "params/layers/single/gate_mlp" in want
    else:
        assert tuple(want["params/embed"].shape) == (4, cfg.vocab_size,
                                                     cfg.d_model)
