"""The port's CUDA kernels on the card, against their plain versions, and the
reduced models on the card against the CPU. Needs only torch and numpy, so
it runs where JAX is absent; every test here is marked ``cuda`` and skips
without a card:

    python -m pytest -m cuda tests/test_torch_card.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve import decode as D  # noqa: E402

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FLASH_CASES = [
    *[(*shape, True, dt)
      for shape in [(1, 256, 4, 4, 64), (2, 256, 4, 2, 32), (1, 512, 8, 2, 64),
                    (1, 128, 2, 1, 128)]
      for dt in ("float32", "bfloat16")],
    (1, 256, 2, 2, 64, False, "float32"),
    *[(*shape, causal, "float32")
      for shape in [(1, 192, 2, 2, 80), (2, 320, 4, 2, 96), (1, 100, 2, 1, 64)]
      for causal in (True, False)],
]
DECODE_SHAPES = [(2, 512, 4, 2, 64), (1, 1024, 8, 8, 32), (3, 300, 4, 2, 128)]


def _tol(dtype):
    """Tolerances of tests/test_kernels.py."""
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(seed, shapes, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(device=device, dtype=DTYPES[dtype]) for s in shapes]


def _np(x):
    return x.float().cpu().numpy()


@pytest.mark.parametrize("b,s,h,kv,d,causal,dtype", FLASH_CASES)
def test_flash_kernel_matches_plain(card, b, s, h, kv, d, causal, dtype):
    q, k, v = _randn(7, [(b, s, h, d), (b, s, kv, d), (b, s, kv, d)], dtype,
                     card)
    before = fa.flash_attention_bhsd.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bhsd.launches == before + 1
    assert got.shape == q.shape and got.dtype == q.dtype and got.is_contiguous()
    want = fa.flash_attention_plain(*(t.permute(0, 2, 1, 3) for t in (q, k, v)),
                                    causal=causal)
    np.testing.assert_allclose(_np(got), _np(want.permute(0, 2, 1, 3)),
                               **_tol(dtype))


@pytest.mark.parametrize("b,s,h,kv,d", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_matches_plain(card, b, s, h, kv, d, dtype):
    q, kc, vc = _randn(8, [(b, 1, h, d), (b, s, kv, d), (b, s, kv, d)], dtype,
                       card)
    lens = torch.from_numpy(np.random.default_rng(9).integers(1, s + 1, b)
                            .astype(np.int32)).to(card)
    before = dec.decode_attention_bhd.launches
    got = ops.decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert dec.decode_attention_bhd.launches == before + 1
    want = dec.decode_attention_plain(q[:, 0], kc.permute(0, 2, 1, 3),
                                      vc.permute(0, 2, 1, 3), lens)
    np.testing.assert_allclose(_np(got[:, 0]), _np(want), **_tol(dtype))


def test_kernels_raise_instead_of_falling_back(card):
    q = torch.zeros(1, 8, 2, 8, dtype=torch.float16, device=card)
    with pytest.raises(TypeError):
        ops.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        ops.decode_attention(q[:, :1], q, q,
                             torch.ones(1, dtype=torch.int32, device=card))


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-8b"])
def test_reduced_model_on_card_matches_cpu(card, arch):
    cfg = get_arch(arch).reduced()
    cpu = M.init_params(cfg, 0, device="cpu")
    gpu = _to(cpu, card)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 37)))
    outs = []
    for params, dev in ((cpu, "cpu"), (gpu, card)):
        pre = D.make_prefill_step(cfg, compute_dtype=torch.float32, device=dev)
        outs.append(_np(pre(params, {"tokens": toks})))
        outs.append(D.greedy_generate(cfg, params, toks[:, :5], 6,
                                      compute_dtype=torch.float32,
                                      device=dev).cpu().numpy())
    np.testing.assert_allclose(outs[2], outs[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(outs[3], outs[1])


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}
