"""bf16 greedy tokens against fp32 ones, in both packages (ROADMAP C,
"Slice 20, bf16 token flips"): reduced olmo-1b and zamba2-7b on the
reference's weights, 16 seeded prompts of 8 tokens and 12 new, the
port's ``greedy_generate`` in fp32 and in bf16 (weights cast once,
``cast_params``) against the reference's serve step in fp32 and its
``greedy_generate`` (bf16).

- Each row's first flip is a near-tie: the port's fp32 top-2 margin at
  that step is at most twice its bf16 logit error there
  (``chip_smoke.first_flips``, which phase 14 runs on the card at full
  width). Measured at these seeds: margins 0.0003–0.0043 against errors
  0.0044–0.0080 (olmo-1b), 0.0089–0.0321 against 0.0565–0.0740
  (zamba2-7b).
- The port's bf16 tokens equal its fp32 tokens no less often than the
  reference's bf16 tokens equal its fp32 ones, less 0.1: a flip changes
  the row's later tokens, and one row's flip at its first step moves the
  rate by 12 of 192 tokens (0.0625); 0.1 is a flip and a half. Measured:
  olmo-1b 0.854 against 0.865, zamba2-7b 0.849 against 0.859.
- Both fp32 runs give the same tokens.
"""
import sys
from pathlib import Path

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
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve import decode as D  # noqa: E402
from repro_torch.train.optimizer import tree_map  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

ROWS, PROMPT, NEW = 16, 8, 12
SLACK = 0.1
CPU = torch.device("cpu")


def _jax_greedy(cfg, params, prompt, dtype):
    """The reference's greedy loop with its serve step at ``dtype``
    (``repro.serve.decode.greedy_generate`` fixes bf16)."""
    if dtype == jnp.bfloat16:
        return np.asarray(JD.greedy_generate(cfg, params, prompt, NEW))
    buf = prompt.shape[1] + NEW
    states = JT.init_decode_state(cfg, prompt.shape[0], buf, dtype=dtype)
    step = jax.jit(JD.make_serve_step(cfg, buf, compute_dtype=dtype))
    cache_len = jnp.zeros((prompt.shape[0],), jnp.int32)
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


@pytest.fixture(scope="module", params=["olmo-1b", "zamba2-7b"])
def runs(request):
    arch = request.param
    cfg, tcfg = get_arch(arch).reduced(), port_arch(arch).reduced()
    params = jax.tree.map(np.asarray, JM.init_params(cfg,
                                                     jax.random.PRNGKey(0)))
    tp, jp = convert.from_numpy(params), jax.tree.map(jnp.asarray, params)
    prompt = np.random.default_rng(42).integers(0, cfg.vocab_size,
                                                (ROWS, PROMPT))
    tprompt = torch.from_numpy(prompt)
    p16 = M.cast_params(tree_map(lambda t: t, tp), torch.bfloat16)
    port32 = D.greedy_generate(tcfg, tp, tprompt, NEW,
                               compute_dtype=torch.float32, device=CPU)
    port16 = D.greedy_generate(tcfg, p16, tprompt, NEW,
                               compute_dtype=torch.bfloat16, device=CPU)
    return {"tcfg": tcfg, "tp": tp, "p16": p16, "prompt": tprompt,
            "port32": port32, "port16": port16,
            "ref32": _jax_greedy(cfg, jp, jnp.asarray(prompt), jnp.float32),
            "ref16": _jax_greedy(cfg, jp, jnp.asarray(prompt), jnp.bfloat16)}


def test_fp32_tokens_equal_the_references(runs):
    np.testing.assert_array_equal(runs["port32"].numpy(), runs["ref32"])


def test_every_first_flip_is_a_near_tie(runs):
    flips = cs.first_flips(runs["tcfg"], runs["tp"], runs["p16"],
                           runs["prompt"], runs["port32"], runs["port16"],
                           CPU)
    flipped = int((runs["port16"] != runs["port32"]).any(1).sum())
    assert len(flips) == flipped > 0
    for f in flips:
        assert f["fp32_margin"] <= 2 * f["bf16_err"], f


def test_bf16_agreement_no_lower_than_the_references(runs):
    port = float((runs["port16"] == runs["port32"]).float().mean())
    ref = float((runs["ref16"] == runs["ref32"]).mean())
    assert port >= ref - SLACK, (port, ref)



def test_router_near_tie_does_not_explain_a_fault():
    """The MoE parity gate's exemption (``chip_smoke.router_near_tie``)
    holds only a disagreement that serving's own routing explains. Reduced
    olmoe-1b-7b on the CPU, a seeded prompt of 24 tokens: its replay is
    the bf16 decode path itself (0 from logits served by the same serve
    step); with no expert choice differing at the last token nothing is
    forced (the forced prefill is the prefill); served logits bumped off
    the decode path's by more than the limit (a fault, not a near-tie)
    are never explained; the wrapped top-k is restored."""
    from repro_torch.models import blocks as B
    from repro_torch.models import transformer as T
    cfg = cs.no_drop(port_arch("olmoe-1b-7b").reduced())
    params = M.init_params(cfg, 0, device=CPU)
    params16 = M.cast_params(M.init_params(cfg, 0, device=CPU),
                             torch.bfloat16)
    n = 24
    prompt = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (1, n)))
    step = D.make_serve_step(cfg, n, device=CPU)
    states = T.init_decode_state(cfg, 1, n, device=CPU, params=params16)
    for t in range(n):
        logits, states, _ = step(params16, states, {
            "tokens": prompt[:, t:t + 1],
            "cache_len": torch.full((1,), t, dtype=torch.int32)})
    served = logits[0].float()
    top_k, limit = B.top_k_lower_first, 1e-2
    got = cs.router_near_tie(cfg, params, {"tokens": prompt}, served, limit)
    assert B.top_k_lower_first is top_k
    assert got["replay_vs_served"] == 0
    if not got["flips"]:
        assert not got["explained"]
        assert got["forced_vs_served"] == got["prefill_vs_served"]
    for bump in (1.0, 10.0):
        off = cs.router_near_tie(cfg, params, {"tokens": prompt},
                                 served + bump, limit)
        assert not off["explained"]
        assert off["replay_vs_served"] == pytest.approx(bump)
