"""The dense family's two large configurations, qwen3-32b and
mistral-nemo-12b, on the port against ``repro`` on the CPU: their attention
blocks in prefill and decode, logits, the prefill and serve steps and the
continuous-batching driver, reduced and at GQA 8:1; the flash and decode
kernels' plain versions at 8:1 (qwen3-32b's 64 query heads on 8 kv heads
of 128 among them) against ``repro.kernels.ref`` and the Pallas kernels in
interpret mode; and the serving-dtype weights that ``init_params(...,
dtype=)`` makes a layer at a time (qwen3-32b's fp32 tree, 131 GB, does not
fit the card that serves its 65.5 GB of bf16 weights).

``.reduced()`` keeps 4 query heads on 1 kv head (4:1) for both, so each
also runs as an "@8:1" variant, 16 query heads on 2 kv heads of 16, made
with ``dataclasses.replace`` in both packages: H·D = 256 against a
d_model of 64, as both full configs have H·D ≠ d_model (8192 and 4096
against 5120). Weights are the reference's init carried across by
``repro_torch/convert.py``, inputs from numpy seeds."""
import dataclasses
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_arch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import decode as JD  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_arch as port_arch  # noqa: E402
from repro_torch.configs.base import list_archs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as L  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.roofline import op_cost  # noqa: E402
from repro_torch.serve import decode as D  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from dryrun_peak import PeakCounter  # noqa: E402

LARGE = ["qwen3-32b", "mistral-nemo-12b"]
ARCHS = LARGE + [f"{a}@8:1" for a in LARGE]
# the "@8:1" variant of a reduced config
GQA8 = {"n_heads": 16, "n_kv_heads": 2}
CPU = "cpu"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# bf16 logits of two frameworks that round at different places agree within
# 5e-2 of their range (test_torch_model.py's bf16 test gives the reason)
BF16_RANGE = 5e-2


def _configs(arch):
    """(reference config, port config) of ``arch`` ("name" or "name@8:1")."""
    name, _, variant = arch.partition("@")
    cfg, tcfg = get_arch(name).reduced(), port_arch(name).reduced()
    if variant:
        cfg = dataclasses.replace(cfg, **GQA8)
        tcfg = dataclasses.replace(tcfg, **GQA8)
    assert cfg.n_heads * cfg.resolved_head_dim != cfg.d_model or not variant
    return cfg, tcfg


def _params(arch):
    cfg, tcfg = _configs(arch)
    params = jax.tree.map(np.asarray, JM.init_params(cfg,
                                                     jax.random.PRNGKey(0)))
    return cfg, tcfg, jax.tree.map(jnp.asarray, params), \
        convert.from_numpy(params)


def _np(x):
    return np.asarray(x.float()) if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _pair(rng, shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# the attention block, logits, the prefill and serve steps
# ---------------------------------------------------------------------------


def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["layers"]["attn"]),
            {k: v[0] for k, v in tp["layers"]["attn"].items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_block_prefill(arch):
    cfg, tcfg, jp, tp = _params(arch)
    jl, tl = _layer0(jp, tp)
    jx, tx = _pair(np.random.default_rng(5), (2, 9, cfg.d_model))
    hd = cfg.resolved_head_dim
    want, _ = JB.attention_block(jl, jx, cfg,
                                 rope=JB.rope_table(9, hd, cfg.rope_theta))
    got, cache = B.attention_block(tl, tx, tcfg,
                                   rope=B.rope_table(9, hd, cfg.rope_theta))
    assert cache is None
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_block_decode(arch):
    """Insert at cache_len, then attend over cache_len + 1 positions (a
    fresh row, a middle one and the buffer's last), RoPE at cache_len."""
    cfg, tcfg, jp, tp = _params(arch)
    jl, tl = _layer0(jp, tp)
    rng = np.random.default_rng(6)
    b, buf, hd = 3, 10, cfg.resolved_head_dim
    jx, tx = _pair(rng, (b, 1, cfg.d_model))
    jk, tk = _pair(rng, (b, buf, cfg.n_kv_heads, hd))
    jv, tv = _pair(rng, (b, buf, cfg.n_kv_heads, hd))
    lens = np.array([0, 4, 9], np.int32)
    want, (wk, wv) = JB.attention_block(
        jl, jx, cfg, rope=JB.rope_table(buf, hd, cfg.rope_theta),
        positions=jnp.asarray(lens)[:, None], kv_cache=(jk, jv),
        cache_len=jnp.asarray(lens))
    tlen = torch.from_numpy(lens)
    got, (gk, gv) = B.attention_block(
        tl, tx, tcfg, rope=B.rope_table(buf, hd, cfg.rope_theta),
        positions=tlen[:, None].long(), kv_cache=(tk, tv), cache_len=tlen)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(gk), _np(wk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(gv), _np(wv), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_fp32(arch):
    cfg, tcfg, jp, tp = _params(arch)
    toks = _tokens(7, (2, 12), cfg.vocab_size)
    ctx = JM.make_ctx(cfg, 12, "train", remat=None, compute_dtype=jnp.float32)
    want, _, _ = JM.forward(jp, jnp.asarray(toks), cfg, ctx)
    tctx = M.make_ctx(tcfg, 12, "prefill", compute_dtype=torch.float32,
                      device=CPU)
    got, _, _ = M.forward(tp, torch.from_numpy(toks), tcfg, tctx)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_step_matches_jax(arch, dtype):
    cfg, tcfg, jp, tp = _params(arch)
    toks = _tokens(2, (3, 10), cfg.vocab_size)
    jd, td = DTYPES[dtype]
    want = _np(JD.make_prefill_step(cfg, compute_dtype=jd)(
        jp, {"tokens": jnp.asarray(toks)}))
    got = D.make_prefill_step(tcfg, compute_dtype=td, device=CPU)(
        tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (3, cfg.vocab_size) and got.dtype == td
    atol = 1e-4 if dtype == "float32" else BF16_RANGE * np.abs(want).max()
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=atol)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_jax(arch):
    """fp32 serve steps on per-slot cache lengths: logits, next tokens and
    the KV caches against the reference's serve step."""
    cfg, tcfg, jp, tp = _params(arch)
    b, buf = 3, 16
    jstep = jax.jit(JD.make_serve_step(cfg, buf, compute_dtype=jnp.float32))
    tstep = D.make_serve_step(tcfg, buf, compute_dtype=torch.float32,
                              device=CPU)
    jst = JT.init_decode_state(cfg, b, buf, dtype=jnp.float32)
    tst = T.init_decode_state(tcfg, b, buf, dtype=torch.float32)
    lens = np.array([0, 3, 7], np.int32)
    toks = _tokens(3, (5, b, 1), cfg.vocab_size)
    for t in range(5):
        jl, jst, jn = jstep(jp, jst, {"tokens": jnp.asarray(toks[t]),
                                      "cache_len": jnp.asarray(lens)})
        tl, tst, tn = tstep(tp, tst, {"tokens": torch.from_numpy(toks[t]),
                                      "cache_len": torch.from_numpy(lens)})
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        lens = lens + 1
    for jc, tc in zip(_leaves(jst), _leaves(tst), strict=True):
        np.testing.assert_allclose(_np(tc), _np(jc), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the continuous-batching driver against the reference's serve step
# ---------------------------------------------------------------------------


def _reference_serve(cfg, jp, prompts, slots, buf, max_new, dtype):
    """``launch/serve.serve``'s loop over the reference's jitted serve step
    (the reference's own driver is its ``main()``, on a fixed workload):
    slots refilled from the queue as they finish, a finished slot's
    cache_len back to 0, idle slots held at position 0. Returns each
    request's tokens and its logits at its prompt's last token."""
    step = jax.jit(JD.make_serve_step(cfg, buf, compute_dtype=dtype))
    states = JT.init_decode_state(cfg, slots, buf, dtype=dtype)
    cache_len = np.zeros((slots,), np.int32)
    cur = np.zeros((slots, 1), np.int32)
    queue, slot_req, feed = list(range(len(prompts))), [-1] * slots, \
        [[] for _ in range(slots)]
    outputs, first = [[] for _ in prompts], [None] * len(prompts)

    def refill(s):
        slot_req[s] = queue.pop(0) if queue else -1
        if slot_req[s] >= 0:
            feed[s] = list(prompts[slot_req[s]])
            cur[s, 0] = feed[s].pop(0)

    for s in range(slots):
        refill(s)
    while any(len(o) < max_new for o in outputs):
        logits, states, nxt = step(jp, states, {
            "tokens": jnp.asarray(cur), "cache_len": jnp.asarray(cache_len)})
        nxt = np.asarray(nxt)
        cache_len += 1
        for s in range(slots):
            r = slot_req[s]
            if r < 0:
                cache_len[s] = 0
                continue
            if feed[s]:
                cur[s, 0] = feed[s].pop(0)
                continue
            if not outputs[r]:
                first[r] = _np(logits[s, -1])
            outputs[r].append(int(nxt[s]))
            cur[s, 0] = nxt[s]
            if len(outputs[r]) >= max_new:
                cache_len[s] = 0
                refill(s)
    return outputs, first


def _driver_pair(arch, dtype):
    cfg, tcfg, jp, tp = _params(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (3, 7, 1, 5, 4)]
    jd, td = DTYPES[dtype]
    want_toks, want_first = _reference_serve(cfg, jp, prompts, 3, 16, 4, jd)
    res = L.serve(tcfg, tp, prompts, slots=3, buf=16, max_new=4,
                  compute_dtype=td, device=CPU)
    return res, want_toks, want_first


@pytest.mark.parametrize("arch", ARCHS)
def test_driver_matches_reference_steps_fp32(arch):
    """3 slots, 5 requests of 1 to 7 tokens and 4 new each, slots refilled
    as they finish: every request's tokens equal, its logits at its
    prompt's last token within 1e-4."""
    res, want_toks, want_first = _driver_pair(arch, "float32")
    assert res.outputs == want_toks
    for got, want in zip(res.first_logits, want_first, strict=True):
        np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_driver_matches_reference_steps_bf16(arch):
    """bf16 compute and caches in both: the logits at each prompt's last
    token (the prompt teacher-forced, so both read the same tokens) within
    5e-2 of their range, as every bf16 comparison of the two packages; the
    first generated token equal wherever the reference's top-2 margin
    there is wider than the two bounds together (else a near-tie may
    round either way). The later tokens follow the first, whatever it
    was, so they are not compared."""
    res, want_toks, want_first = _driver_pair(arch, "bfloat16")
    compared = 0
    for r, (got, want) in enumerate(zip(res.first_logits, want_first,
                                        strict=True)):
        bound = BF16_RANGE * np.abs(want).max()
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=bound)
        top2 = np.sort(want)[-2:]
        if top2[1] - top2[0] > 2 * bound:
            assert res.outputs[r][0] == want_toks[r][0], r
            compared += 1
    assert all(len(o) == 4 for o in res.outputs)
    assert compared >= 1


# ---------------------------------------------------------------------------
# the kernels' plain versions at GQA 8:1
# ---------------------------------------------------------------------------

# (b, s, h, kv, d): 16 on 2 kv heads, and qwen3-32b's 64 on 8 of 128
FLASH_8TO1 = [(2, 128, 16, 2, 32), (1, 128, 64, 8, 128)]
DECODE_8TO1 = [(2, 256, 16, 2, 32), (2, 128, 64, 8, 128)]


def _tol(dtype):
    """tests/test_kernels.py's tolerances: bf16 keeps 8 bits of mantissa."""
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


@pytest.mark.parametrize("b,s,h,kv,d", FLASH_8TO1)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_at_8_to_1_matches_ref_and_pallas(b, s, h, kv, d, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        0, [(b, s, h, d), (b, s, kv, d), (b, s, kv, d)], dtype)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.shape == (b, s, h, d) and got.dtype == tq.dtype
    np.testing.assert_allclose(
        _np(got), _np(jref.attention_ref(jq, jk, jv, causal=True)),
        **_tol(dtype))
    np.testing.assert_allclose(
        _np(got), _np(jops.flash_attention(jq, jk, jv, causal=True,
                                           interpret=True)), **_tol(dtype))


@pytest.mark.parametrize("b,s,h,kv,d", DECODE_8TO1)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_at_8_to_1_matches_ref_and_pallas(b, s, h, kv, d,
                                                       dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        1, [(b, 1, h, d), (b, s, kv, d), (b, s, kv, d)], dtype)
    lens = np.array([1, s][:b], np.int32)        # one key; the whole buffer
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert got.shape == (b, 1, h, d) and got.dtype == tq.dtype
    jl = jnp.asarray(lens)
    np.testing.assert_allclose(
        _np(got[:, 0]), _np(jref.decode_attention_ref(
            jq[:, 0], jnp.swapaxes(jk, 1, 2), jnp.swapaxes(jv, 1, 2), jl)),
        **_tol(dtype))
    np.testing.assert_allclose(
        _np(got), _np(jops.decode_attention(jq, jk, jv, jl, block_k=128,
                                            interpret=True)), **_tol(dtype))
    np.testing.assert_allclose(
        _np(got), _np(JB.decode_attention(jq, jk, jv, jl)), **_tol(dtype))


# ---------------------------------------------------------------------------
# weights made in the serving dtype, a layer at a time
# ---------------------------------------------------------------------------


def _flat(tree):
    return convert.flatten(tree)


@pytest.mark.parametrize("arch", list_archs())
def test_serving_dtype_init_has_cast_params_dtypes(arch):
    """``init_params(dtype=bf16)`` is ``cast_params(init_params(cfg))``
    bit for bit: the same draws, each leaf of the same shape and dtype
    (norms, the recurrent vectors and the VLM's gates and cross K/V
    fp32)."""
    cfg = port_arch(arch).reduced()
    want = _flat(M.cast_params(M.init_params(cfg, 0, device=CPU),
                               torch.bfloat16))
    got = _flat(M.init_params(cfg, 0, device=CPU, dtype=torch.bfloat16))
    assert got.keys() == want.keys()
    for key in want:
        assert (got[key].shape, got[key].dtype) == \
            (want[key].shape, want[key].dtype), key
        assert torch.equal(got[key], want[key]), key
    assert {torch.bfloat16, torch.float32} >= \
        {t.dtype for t in got.values()}


@pytest.mark.parametrize("arch", LARGE + ["zamba2-7b",
                                          "llama-3.2-vision-11b"])
def test_serving_dtype_init_keeps_each_leafs_scale(arch):
    """Each leaf's std in bf16 against the reference's init (other draws of
    the same distribution), at 8 layers: within 6 standard errors of the
    difference of two normal samples' stds, 6 / sqrt(n) of the std, plus
    bf16's rounding (2^-8); the constant leaves (norm scales, zeros)
    equal."""
    name = arch
    cfg = dataclasses.replace(get_arch(name).reduced(), n_layers=8)
    want = _flat(convert.from_numpy(jax.tree.map(
        np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))))
    tcfg = dataclasses.replace(port_arch(name).reduced(), n_layers=8)
    got = _flat(M.init_params(tcfg, 0, device=CPU, dtype=torch.bfloat16))
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key].float()
        assert g.shape == w.shape, key
        if w.numel() < 2:
            continue
        if float(w.std()) == 0:
            assert torch.equal(g, w), key
            continue
        tol = 6 / math.sqrt(w.numel()) + 2 ** -8
        assert abs(float(g.std()) - float(w.std())) <= tol * float(w.std()), \
            key


@pytest.mark.parametrize("arch", LARGE + ["zamba2-7b"])
def test_init_cut_keeps_embedding_head_and_first_layers(arch):
    """A model cut to fewer layers has the whole model's embedding, head
    and first layers bit for bit (they are drawn in that order), so the
    card's parity gate can measure a deep model's bf16 rounding on a cut
    of the same weights."""
    full = port_arch(arch).reduced()
    cut = dataclasses.replace(full, n_layers=full.n_layers // 2)
    whole = M.init_params(full, 0, device=CPU)
    part = M.init_params(cut, 0, device=CPU)
    for key in ("embed", "lm_head"):
        if key in whole:
            assert torch.equal(part[key], whole[key]), key
    layers = whole["layers"].get("inner", whole["layers"])
    for key, leaf in _flat(part["layers"].get("inner",
                                              part["layers"])).items():
        n = leaf.shape[0]
        assert torch.equal(leaf, _flat(layers)[key][:n]), key


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in _flat(tree).values())


def _by_dtype(counter, t):
    return t.dtype


@pytest.mark.parametrize("arch", LARGE)
def test_serving_dtype_init_holds_one_layer_in_fp32(arch):
    """Making the stack in bf16 (``transformer.init_stack``) keeps at most
    one layer's fp32 leaves live beside the stack's own fp32 leaves (the
    norms), never a stacked fp32 leaf; the whole tree's largest fp32
    storage is one layer's largest leaf, the embedding's or the head's
    (each drawn in fp32 and cast alone). Live bytes by dtype are read with
    ``tools/dryrun_peak.py``'s ``PeakCounter``."""
    cfg = dataclasses.replace(port_arch(arch).reduced(), n_layers=8)
    layer = T.init_layer("dense", cfg, torch.Generator().manual_seed(0))
    layer_fp32 = _nbytes(layer)
    largest_leaf = max(t.numel() * 4 for t in _flat(layer).values())
    stacked_leaf = cfg.n_layers * largest_leaf

    def dtype_of(path):
        return torch.float32 if M.stays_fp32(path) else torch.bfloat16

    with PeakCounter(key=_by_dtype) as counter:
        stack = T.init_stack(cfg, torch.Generator().manual_seed(0), dtype_of)
    kept = sum(t.numel() * 4 for t in _flat(stack).values()
               if t.dtype == torch.float32)
    assert kept and counter.peak_by[torch.float32] <= kept + layer_fp32
    assert counter.largest_by[torch.float32] == largest_leaf < stacked_leaf
    with PeakCounter(key=_by_dtype) as counter:
        M.init_params(cfg, 0, device=CPU, dtype=torch.bfloat16)
    ends = max(cfg.vocab_size * cfg.d_model * 4, largest_leaf)
    assert counter.largest_by[torch.float32] == ends < stacked_leaf
