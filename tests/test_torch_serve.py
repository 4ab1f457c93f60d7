"""Serving on the port: decode equals the parallel forward under teacher
forcing, the prefill and serve steps and greedy generation agree with
``repro.serve.decode`` on converted weights, and the continuous-batching
driver gives each request what it would get alone."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_arch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import decode as JD  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_arch as port_arch  # noqa: E402
from repro_torch.launch import serve as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import decode as D  # noqa: E402

ARCHS = ["olmo-1b", "qwen3-8b"]
RECURRENT = ["rwkv6-7b", "zamba2-7b"]
# decode ticks of at most 4 tokens drop nothing at the reduced MoE
# capacity (4), so these serve paths are the reference's; prefill under
# capacity is in test_torch_moe.py
MOE = ["olmoe-1b-7b", "llama4-scout-17b-a16e"]
CPU = "cpu"
# leaves the reference initialises to zero; seeded here in both packages
ZERO_INIT = ("bonus_u", "shift_lora_b", "decay_lora_b")


def _exercise(tree, rng):
    return {k: _exercise(v, rng) if isinstance(v, dict)
            else (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
            if k in ZERO_INIT else v for k, v in tree.items()}


def _params(arch):
    cfg = get_arch(arch).reduced()
    params = _exercise(jax.tree.map(np.asarray, JM.init_params(
        cfg, jax.random.PRNGKey(0))), np.random.default_rng(9))
    return cfg, port_arch(arch).reduced(), \
        jax.tree.map(jnp.asarray, params), convert.from_numpy(params)


def _leaves(tree):
    """Leaves of a decode state (dicts in key order, tuples in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.mark.parametrize("arch", ARCHS + RECURRENT)
def test_decode_matches_parallel_forward(arch):
    """Port of tests/test_serve.py's teacher-forcing parity, fp32."""
    cfg, tcfg, jp, tp = _params(arch)
    b, s = 2, 12
    toks = torch.from_numpy(_tokens(1, (b, s), cfg.vocab_size))
    ctx = M.make_ctx(tcfg, s, "prefill", compute_dtype=torch.float32,
                     device=CPU)
    ref, _, _ = M.forward(tp, toks, tcfg, ctx)
    states = T.init_decode_state(tcfg, b, s, dtype=torch.float32)
    cache_len = torch.zeros((b,), dtype=torch.int32)
    outs = []
    for t in range(s):
        dctx = M.make_ctx(tcfg, s, "decode", cache_len=cache_len,
                          compute_dtype=torch.float32, device=CPU)
        logits, states = M.decode_step(tp, toks[:, t:t + 1], states,
                                       cache_len, tcfg, dctx)
        outs.append(logits)
        cache_len = cache_len + 1
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), ref.numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS + RECURRENT)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_step_matches_jax(arch, dtype):
    cfg, tcfg, jp, tp = _params(arch)
    toks = _tokens(2, (3, 10), cfg.vocab_size)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = np.asarray(JD.make_prefill_step(cfg, compute_dtype=jd)(
        jp, {"tokens": jnp.asarray(toks)}), np.float32)
    got = D.make_prefill_step(tcfg, compute_dtype=td, device=CPU)(
        tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (3, cfg.vocab_size) and got.dtype == td
    # bf16: 5e-2 of the logits' range (see test_torch_model's bf16 test),
    # except reduced RWKV-6, whose bf16 logits are noisy in both packages:
    # there the port's bf16 error may be at most 1.5x JAX's own
    if dtype == "bfloat16" and arch == "rwkv6-7b":
        fp32 = np.asarray(JD.make_prefill_step(cfg, compute_dtype=jnp.float32)(
            jp, {"tokens": jnp.asarray(toks)}), np.float32)
        assert np.abs(got.float().numpy() - fp32).max() <= \
            1.5 * np.abs(want - fp32).max()
        return
    atol = 1e-4 if dtype == "float32" else 5e-2 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("arch", ARCHS + RECURRENT + MOE)
def test_serve_step_matches_jax(arch):
    """A few fp32 serve steps on per-slot cache lengths: logits, caches and
    next tokens agree with the reference's serve step."""
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
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        lens = lens + 1
    jleaves, tleaves = _leaves(jst), _leaves(tst)
    assert len(jleaves) == len(tleaves)
    # a KV cache holds one projection per token (1e-5); a recurrent state
    # sums products of several tokens' projections, of magnitude up to ~4
    # here, so it carries their rounding: 2e-4
    tol = 1e-5 if arch in ARCHS else 2e-4
    for jc, tc in zip(jleaves, tleaves):
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=tol,
                                   atol=tol)


def _jax_greedy_fp32(cfg, params, prompt, max_new):
    """repro.serve.decode.greedy_generate's loop with fp32 compute and cache
    (the reference function itself fixes both to bf16)."""
    b = prompt.shape[0]
    buf = prompt.shape[1] + max_new
    states = JT.init_decode_state(cfg, b, buf, dtype=jnp.float32)
    step = jax.jit(JD.make_serve_step(cfg, buf, compute_dtype=jnp.float32))
    cache_len = jnp.zeros((b,), jnp.int32)
    cur, out = prompt[:, :1], []
    for i in range(buf - 1):
        _, states, nxt = step(params, states,
                              {"tokens": cur, "cache_len": cache_len})
        cache_len = cache_len + 1
        if i + 1 < prompt.shape[1]:
            cur = prompt[:, i + 1:i + 2]
        else:
            cur = nxt[:, None]
            out.append(cur)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch", ARCHS + RECURRENT + MOE)
def test_greedy_generate_matches_jax_fp32(arch):
    cfg, tcfg, jp, tp = _params(arch)
    prompt = _tokens(4, (2, 5), cfg.vocab_size)
    want = _jax_greedy_fp32(cfg, jp, jnp.asarray(prompt), 6)
    got = D.greedy_generate(tcfg, tp, torch.from_numpy(prompt), 6,
                            compute_dtype=torch.float32, device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_generate_shapes():
    """Port of tests/test_serve.py::test_greedy_generate_shapes (bf16)."""
    tcfg = port_arch("olmo-1b").reduced()
    params = M.init_params(tcfg, 0, device=CPU)
    prompt = torch.from_numpy(_tokens(1, (2, 5), tcfg.vocab_size))
    out = D.greedy_generate(tcfg, params, prompt, 4, device=CPU)
    assert out.shape == (2, 4)
    assert bool((out >= 0).all()) and bool((out < tcfg.vocab_size).all())


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "musicgen-large"])
def test_greedy_generate_shapes_with_vision_and_codebooks(arch):
    """test_greedy_generate_shapes (bf16) with vision states (the VLM) and
    with frames of 4 codebooks (musicgen): (B, new) and (B, new, K)."""
    tcfg = port_arch(arch).reduced()
    params = M.init_params(tcfg, 0, device=CPU)
    books = (tcfg.n_codebooks,) if tcfg.n_codebooks else ()
    prompt = torch.from_numpy(_tokens(1, (2, 5, *books), tcfg.vocab_size))
    vision = torch.randn(2, tcfg.n_vision_tokens, tcfg.vision_dim) \
        if tcfg.family == "vlm" else None
    out = D.greedy_generate(tcfg, params, prompt, 4, vision=vision,
                            device=CPU)
    assert out.shape == (2, 4, *books)
    assert bool((out >= 0).all()) and bool((out < tcfg.vocab_size).all())


@pytest.mark.parametrize("arch", ARCHS + RECURRENT)
def test_driver_outputs_equal_each_prompt_alone(arch):
    """Continuous batching (3 slots, 5 requests of different lengths, slots
    refilled as they finish) gives each request the tokens, and the logits
    at its prompt's last token, that it gets served alone."""
    _, tcfg, _, tp = _params(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist()
               for n in (3, 7, 1, 5, 4)]
    res = L.serve(tcfg, tp, prompts, slots=3, buf=16, max_new=4,
                  compute_dtype=torch.float32, device=CPU)
    assert res.ticks < sum(len(p) + 3 for p in prompts)   # slots overlapped
    pre = D.make_prefill_step(tcfg, compute_dtype=torch.float32, device=CPU)
    for r, p in enumerate(prompts):
        alone = D.greedy_generate(tcfg, tp, torch.tensor([p]), 4,
                                  compute_dtype=torch.float32, device=CPU)
        assert res.outputs[r] == alone[0].tolist(), r
        last = pre(tp, {"tokens": torch.tensor([p])})[0]
        np.testing.assert_allclose(res.first_logits[r].numpy(), last.numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", RECURRENT)
def test_driver_without_slot_reset_leaks_state(arch, monkeypatch):
    """The control for the test above: the reference driver resets only a
    refilled slot's cache_len. Without ``reset_slot`` a refilled slot starts
    from the state its last request left, and its request's logits change."""
    _, tcfg, _, tp = _params(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist()
               for n in (3, 7, 1, 5, 4)]
    kw = dict(slots=3, buf=16, max_new=4, compute_dtype=torch.float32,
              device=CPU)
    good = L.serve(tcfg, tp, prompts, **kw)
    monkeypatch.setattr(T, "reset_slot", lambda states, s: None)
    stale = L.serve(tcfg, tp, prompts, **kw)
    for r in range(3):                   # the first requests see fresh slots
        assert torch.equal(stale.first_logits[r], good.first_logits[r])
    assert max((stale.first_logits[r] - good.first_logits[r]).abs().max()
               for r in range(3, 5)) > 1e-3


def test_reset_slot_zeroes_only_that_slot_recurrent_state():
    for arch in RECURRENT:
        tcfg = port_arch(arch).reduced()
        states = T.init_decode_state(tcfg, 3, 8, dtype=torch.float32)
        for t in _leaves(states):
            t.fill_(1.0)
        T.reset_slot(states, 1)
        if "layers" in states:
            parts = [(states["layers"], 1, True)]
        else:
            parts = [(states["inner"], 2, True), (states["trailing"], 1, True),
                     (states["single"], 1, False)]     # KV caches stay
        for leaves, dim, zeroed in parts:
            for t in leaves:
                assert bool((t.select(dim, 1) == 0).all()) == zeroed, arch
                assert bool((t.select(dim, 0) == 1).all()), arch
                assert bool((t.select(dim, 2) == 1).all()), arch


def test_driver_keeps_positions_inside_the_buffer():
    """buf must hold the longest prompt plus max_new; idle slots (more slots
    than requests) stay at position 0 instead of running past the cache."""
    tcfg = port_arch("olmo-1b").reduced()
    params = M.init_params(tcfg, 0, device=CPU)
    prompts = [[1, 2, 3], [4]]
    with pytest.raises(ValueError):
        L.serve(tcfg, params, prompts, slots=2, buf=6, max_new=4, device=CPU)
    res = L.serve(tcfg, params, prompts, slots=4, buf=7, max_new=4,
                  device=CPU)
    assert [len(o) for o in res.outputs] == [4, 4]


def test_launch_main_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["serve", "--requests", "3", "--slots",
                                     "2", "--max-new", "2", "--device", "cpu"])
    L.main()
    out = capsys.readouterr().out
    assert "served 3/3 requests" in out and out.count("request ") == 3
