"""Phase 5's parity gate (``chip_smoke.check_parity``) on the CPU, at
reduced size: bf16 prefill logits against the serving driver's, each
request within 5e-2 of its range or twice the model's bf16 rounding.

An MoE request beyond its limit passes only where ``router_near_tie``
explains it: a layer whose expert choice differs between the two bf16
paths at a near-tie in fp32, and the prefill with serving's choices
forced agreeing with the served logits. These tests hold the gate's two
sides on reduced olmoe-1b-7b and olmo-1b: the served logits pass, and a
served row moved beyond its limit fails, with no near-tie to excuse it
(the replay through the serve step does not reproduce a moved row, and
no expert choice differs).
"""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.launch import serve as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve import decode as D  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

CPU = torch.device("cpu")
REQUESTS, SLOTS, BUF, NEW = 3, 2, 32, 4


def _served(arch):
    """Reduced ``arch``'s fp32 weights, its requests as batches of one row,
    and each request's bf16 prefill and served logits at its last prompt
    token, as ``chip_smoke.run_slice`` makes them."""
    cfg = get_arch(arch).reduced()
    params16 = M.init_params(cfg, 0, device=CPU, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(6, 13)).tolist()
               for _ in range(REQUESTS)]
    res = L.serve(cfg, params16, prompts, slots=SLOTS, buf=BUF, max_new=NEW,
                  device=CPU)
    prefill = D.make_prefill_step(cs.no_drop(cfg), device=CPU)
    batches = [{"tokens": torch.tensor([p])} for p in prompts]
    pre16 = [prefill(params16, b)[0].float() for b in batches]
    served16 = [s.float().cpu() for s in res.first_logits]
    return cfg, M.init_params(cfg, 0, device=CPU), batches, pre16, served16


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "olmo-1b"])
def test_parity_gate_passes_the_served_logits(arch):
    cfg, params, batches, pre16, served16 = _served(arch)
    out = cs.check_parity(cs.no_drop(cfg), params, batches, pre16, served16,
                          "cpu")
    assert len(out["requests"]) == REQUESTS
    for err, limit, _, _, _, tie in out["requests"]:
        assert err <= limit and tie is None


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "olmo-1b"])
def test_parity_gate_refuses_a_served_row_beyond_its_limit(arch):
    cfg, params, batches, pre16, served16 = _served(arch)
    moved = served16[1].clone()
    moved[0] += 0.5 * pre16[1].abs().max() + 10.0
    with pytest.raises(AssertionError, match="request 1") as err:
        cs.check_parity(cs.no_drop(cfg), params, batches, pre16,
                        [served16[0], moved, served16[2]], "cpu")
    if cfg.moe is not None:                   # the near-tie was looked for
        assert '"explained": false' in str(err.value)


def test_router_near_tie_finds_no_flip_where_the_paths_agree():
    """The replay of a request through the bf16 serve step stands for its
    served logits, and where no expert choice differs nothing is explained,
    so a disagreement there stays a failure."""
    cfg, params, batches, pre16, served16 = _served("olmoe-1b-7b")
    limit = 5e-2 * pre16[0].abs().max().item()
    tie = cs.router_near_tie(cs.no_drop(cfg), params, batches[0], served16[0],
                             limit)
    assert tie["replay_vs_served"] <= limit
    assert tie["flips"] == [] and tie["explained"] is False
    assert tie["forced_vs_served"] == tie["prefill_vs_served"]
