"""The port's CUDA kernels on the card, against their plain versions, the
train path's scans, the reduced models (MoE, VLM and audio included) on the
card against the CPU, decode on two streams at once, the thread runner's
per-worker streams and the subprocess runner's wait for its job's stream,
and the dry-run: its counts on fake CUDA tensors equal its counts on fake
CPU tensors, and the kernels' fake branches never take a real tensor.
Needs only torch and numpy, so it runs where JAX is absent; every test here
is marked ``cuda`` and skips without a card:

    python -m pytest -m cuda tests/test_torch_card.py
"""
import os
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.core.acai import AcaiEngine, AcaiProject  # noqa: E402
from repro_torch.core.provision import autotune as AT  # noqa: E402
from repro_torch.core.engine.registry import JobSpec  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba2_ssd as ssd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import wkv6 as wkv  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.models import mamba as MB  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import rwkv as R  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.roofline import op_cost  # noqa: E402
from repro_torch.serve import decode as D  # noqa: E402
from repro_torch.train.checkpoints import CheckpointManager  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         adamw_update, tree_map)
from repro_torch.train import train_step as T  # noqa: E402

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
    # zamba2-7b's shared attention block: head dim 112
    (2, 200, 4, 4, 112, True, "float32"), (1, 256, 4, 4, 112, True, "bfloat16"),
    # the bf16 kernel's edges: ragged S, head dims 16, 80 and 112 below its
    # 64/112/128 tile widths, GQA 4:1, causal and not
    *[(*shape, causal, "bfloat16")
      for shape in [(1, 100, 2, 1, 64), (2, 601, 8, 2, 80), (1, 601, 4, 1, 16),
                    (2, 300, 8, 2, 112)]
      for causal in (True, False)],
    # llama4-scout's GQA: 40 query heads on 8 kv heads (5:1), head dim 128
    (1, 256, 40, 8, 128, True, "float32"), (2, 512, 40, 8, 128, True, "bfloat16"),
    # musicgen-large's heads: 32 on 32 kv heads of 64 (the bf16 kernel's
    # 64-wide tile); llama-3.2-vision-11b's: 32 on 8 of 128
    *[(1, 512, 32, 32, 64, True, dt) for dt in ("float32", "bfloat16")],
    (1, 256, 32, 8, 128, True, "bfloat16"),
    # qwen3-32b's heads: 64 on 8 kv heads of 128 (GQA 8:1)
    (1, 256, 64, 8, 128, True, "float32"), (2, 512, 64, 8, 128, True, "bfloat16"),
]
DECODE_SHAPES = [(2, 512, 4, 2, 64), (1, 1024, 8, 8, 32), (3, 300, 4, 2, 128),
                 (2, 300, 4, 4, 112), (4, 256, 40, 8, 128),
                 (4, 288, 32, 32, 64), (4, 288, 32, 8, 128),
                 (4, 256, 64, 8, 128)]        # qwen3-32b's, GQA 8:1
# cache_len of 1, of the whole buffer and of 0 (zeros), GQA 4:1, head dim 112
DECODE_EDGE_SHAPES = [(4, 1024, 16, 16, 128), (3, 512, 8, 2, 128),
                      (3, 300, 16, 4, 112), (2, 64, 4, 1, 64)]
# tests/test_kernels.py's shapes, and a length no chunk divides
WKV6_SHAPES = [(1, 128, 2, 32), (2, 256, 4, 64), (1, 64, 1, 16),
               (1, 601, 2, 64)]
# the bf16 chunked kernel's edges: S around its 64-token chunk and a ragged
# tail, K below and at its 64-channel tile
WKV6_EDGE_CASES = [(s, k) for s in (1, 63, 64, 65, 601) for k in (16, 32, 64)]
SSD_SHAPES = [(1, 128, 2, 32, 1, 16), (2, 256, 4, 64, 2, 32),
              (1, 64, 2, 16, 1, 8), (1, 601, 4, 64, 1, 64)]
# the bf16 chunked kernel's edges: S around its 64-token chunk and a ragged
# tail, P below, at and above its 64-column tile, N of 8 and 64, two groups
SSD_EDGE_CASES = [(s, p, n) for s in (1, 63, 64, 65, 601)
                  for p, n in ((16, 8), (32, 64), (128, 64), (128, 8))]


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


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_reads_fused_qkv_views(card, causal):
    """q, k and v as strided views of one (B, S, 3, H, D) projection."""
    b, s, h, d = 2, 300, 4, 64
    (qkv,) = _randn(15, [(b, s, 3, h, d)], "bfloat16", card)
    q, k, v = qkv.unbind(2)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(
        *(t.contiguous().permute(0, 2, 1, 3) for t in (q, k, v)),
        causal=causal)
    np.testing.assert_allclose(_np(got), _np(want.permute(0, 2, 1, 3)),
                               **_tol("bfloat16"))


def test_flash_kernel_takes_contiguous_bhsd(card):
    """(B, H, S, D) tensors, whose head stride exceeds their sequence
    stride, as flash_attention_bhsd's own callers may pass them."""
    q, k, v = _randn(16, [(2, 4, 300, 64), (2, 2, 300, 64), (2, 2, 300, 64)],
                     "bfloat16", card)
    got = fa.flash_attention_bhsd(q, k, v)
    np.testing.assert_allclose(_np(got), _np(fa.flash_attention_plain(q, k, v)),
                               **_tol("bfloat16"))


def test_flash_kernel_refuses_layouts_tma_cannot_take(card):
    buf = torch.zeros(1, 64, 2, 72, dtype=torch.bfloat16, device=card)
    shifted = buf[..., 1:65]                # base 2 bytes past 16-byte alignment
    ragged = torch.zeros(1, 64, 2, 68, dtype=torch.bfloat16,
                         device=card)[..., :64]      # head stride of 136 bytes
    before = fa.flash_attention_bhsd.launches
    for t in (shifted, ragged):
        with pytest.raises(ValueError):
            ops.flash_attention(t, t, t)
    assert fa.flash_attention_bhsd.launches == before


@pytest.mark.parametrize("b,s,h,kv,d", DECODE_EDGE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_cache_len_edges(card, b, s, h, kv, d, dtype):
    q, kc, vc = _randn(16, [(b, 1, h, d), (b, s, kv, d), (b, s, kv, d)],
                       dtype, card)
    lens = torch.tensor([1, s, 0, s // 2 + 3][:b], dtype=torch.int32,
                        device=card)
    got = ops.decode_attention(q, kc, vc, lens)
    want = dec.decode_attention_plain(q[:, 0], kc.permute(0, 2, 1, 3),
                                      vc.permute(0, 2, 1, 3), lens)
    np.testing.assert_allclose(_np(got[:, 0]), _np(want), **_tol(dtype))
    if b > 2:
        assert not bool(got[2].any())           # the empty row gives zeros


# the partial softmax (return_lse) at GQA 4:1, head dims 128 and 112, a
# split of 64 positions; rows of 0, 1, one whole split and the whole buffer
LSE_SHAPES = [(4, 512, 16, 4, 128), (4, 320, 16, 4, 112)]
LSE_SPLIT = 64


def _lse_inputs(b, s, h, kv, d, dtype, card):
    q, kc, vc = _randn(18, [(b, 1, h, d), (b, s, kv, d), (b, s, kv, d)],
                       dtype, card)
    lens = torch.tensor([0, 1, LSE_SPLIT, s][:b], dtype=torch.int32,
                        device=card)
    return q, kc, vc, lens


@pytest.mark.parametrize("b,s,h,kv,d", LSE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_partial_softmax_matches_plain(card, b, s, h, kv, d, dtype):
    """o in fp32 and lse against the plain version's; the empty row's o is
    zeros and its lse -inf; one launch a call."""
    q, kc, vc, lens = _lse_inputs(b, s, h, kv, d, dtype, card)
    before = dec.decode_attention_bhd.launches
    o, lse = ops.decode_attention(q, kc, vc, lens, split=LSE_SPLIT,
                                  return_lse=True)
    torch.cuda.synchronize()
    assert dec.decode_attention_bhd.launches == before + 1
    assert o.dtype == torch.float32 and o.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (b, h)
    want_o, want_lse = dec.decode_attention_plain(
        q[:, 0], kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3), lens,
        return_lse=True)
    assert not bool(o[0].any()) and bool(torch.isneginf(lse[0]).all())
    # both sides compute in fp32 from the same inputs: fp32's tolerance
    np.testing.assert_allclose(_np(o[:, 0]), _np(want_o), **_tol("float32"))
    np.testing.assert_allclose(_np(lse[1:]), _np(want_lse[1:]),
                               **_tol("float32"))


@pytest.mark.parametrize("b,s,h,kv,d", LSE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_output_without_lse_is_the_partial_softmax_rounded(
        card, b, s, h, kv, d, dtype):
    """The call without return_lse gives the partial softmax's o rounded to
    the input dtype, bit for bit: the two instances compute one thing."""
    q, kc, vc, lens = _lse_inputs(b, s, h, kv, d, dtype, card)
    o, _ = ops.decode_attention(q, kc, vc, lens, split=LSE_SPLIT,
                                return_lse=True)
    plain = ops.decode_attention(q, kc, vc, lens, split=LSE_SPLIT)
    assert plain.dtype == q.dtype
    assert torch.equal(o.to(q.dtype), plain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_pieces_merged_on_the_card_match_the_whole_cache(card, dtype):
    """Each half of the buffer through the kernel's partial softmax, merged
    by ``spmd.merge_pieces``, against the whole cache's partial softmax
    (fp32 both, fp32's tolerance) and its output in the input dtype."""
    from repro_torch.sharding import spmd as S
    b, s, h, kv, d = 4, 512, 16, 4, 128
    q, kc, vc, _ = _lse_inputs(b, s, h, kv, d, dtype, card)
    lens = torch.tensor([300, 256, 17, 512], dtype=torch.int32, device=card)
    n = s // 2
    pieces = [ops.decode_attention(
        q, kc[:, j * n:(j + 1) * n], vc[:, j * n:(j + 1) * n],
        (lens - j * n).clamp(0, n), return_lse=True) for j in range(2)]
    merged, merged_lse = S.merge_pieces([(o[:, 0], lse) for o, lse in pieces])
    whole_o, whole_lse = ops.decode_attention(q, kc, vc, lens,
                                              return_lse=True)
    np.testing.assert_allclose(_np(merged), _np(whole_o[:, 0]),
                               **_tol("float32"))
    np.testing.assert_allclose(_np(merged_lse), _np(whole_lse),
                               **_tol("float32"))
    whole = ops.decode_attention(q, kc, vc, lens)
    np.testing.assert_allclose(_np(merged.to(q.dtype)), _np(whole[:, 0]),
                               **_tol(dtype))


def _one_kernel_per_call(fn, calls=5):
    """Whether each of ``calls`` calls of fn enqueues exactly one CUDA
    kernel, from the profiler: the window holds the calls between two
    throwaway spin kernels, exactly one kernel name besides the spins, and
    that kernel's ``calls`` records, or one fewer. On some cards the
    profiler dropped the first or last kernel records of a window, and a
    single-call window has been seen to hold none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        for _ in range(calls):
            fn()
        torch.cuda._sleep(20_000_000)
        torch.cuda.synchronize()
    records = [e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and "spin_kernel" not in e.key]
    return len(records) == 1 and records[0] in (calls - 1, calls)


def test_decode_call_is_one_kernel_launch(card):
    """Each call adds one to the counter and enqueues exactly one CUDA
    kernel, the merge of the splits included."""
    q, kc, vc = _randn(17, [(4, 1, 16, 128), (4, 1024, 16, 128),
                            (4, 1024, 16, 128)], "bfloat16", card)
    lens = torch.tensor([700, 1024, 33, 512], dtype=torch.int32, device=card)
    ops.decode_attention(q, kc, vc, lens)       # builds; tickets allocated
    before = dec.decode_attention_bhd.launches
    one = _one_kernel_per_call(lambda: ops.decode_attention(q, kc, vc, lens))
    assert dec.decode_attention_bhd.launches == before + 5
    assert one


def _recurrence_tol(dtype, f32):
    """tests/test_kernels.py's tolerances: f32 for WKV6 (2e-4) or SSD
    (5e-4), bf16 outputs rounded to 8 bits of mantissa (2e-2)."""
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=f32, atol=f32)


def _wkv6_inputs(seed, b, s, h, k, dtype, card, logw_range=(-7.0, -0.7)):
    """tests/test_kernels.py's draws; logw = -exp(U(logw_range)) and u stay
    fp32, as in the model."""
    rng = np.random.default_rng(seed)
    r, kk, v = (torch.from_numpy((rng.standard_normal((b, s, h, k)) * 0.5)
                                 .astype(np.float32))
                .to(device=card, dtype=DTYPES[dtype]) for _ in range(3))
    logw = torch.from_numpy(-np.exp(rng.uniform(*logw_range, (b, s, h, k)))
                            .astype(np.float32)).to(card)
    u = torch.from_numpy((rng.standard_normal((h, k)) * 0.3)
                         .astype(np.float32)).to(card)
    return r, kk, v, logw, u


@pytest.mark.parametrize("b,s,h,k", WKV6_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_kernel_matches_plain(card, b, s, h, k, dtype):
    r, kk, v, logw, u = _wkv6_inputs(10, b, s, h, k, dtype, card)
    before = wkv.wkv6_bhsk.launches
    got = ops.wkv6(r, kk, v, logw, u)
    torch.cuda.synchronize()
    assert wkv.wkv6_bhsk.launches == before + 1
    assert got.shape == r.shape and got.dtype == r.dtype and got.is_contiguous()
    tr = lambda a: a.permute(0, 2, 1, 3)
    want = tr(wkv.wkv6_plain(tr(r), tr(kk), tr(v), tr(logw), u))
    np.testing.assert_allclose(_np(got), _np(want),
                               **_recurrence_tol(dtype, 2e-4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_kernel_strong_decay_matches_sequential_ref(card, dtype):
    """logw in (-3, -0.3): the reference's chunked forms overflow there.
    fp32 takes the scalar kernel, bf16 the chunked one, whose every
    exponent is a non-positive difference clamped at 0; both stay finite
    and match the sequential oracle on the same inputs."""
    r, kk, v, logw, u = _wkv6_inputs(11, 1, 512, 2, 64, dtype, card,
                                     (np.log(0.3), np.log(3.0)))
    got = ops.wkv6(r, kk, v, logw, u)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), _np(ref.wkv6_ref(r, kk, v, logw, u)),
                               **_recurrence_tol(dtype, 2e-4))


def _wkv6_model_views(seed, b, s, h, k, card, logw_range=(-7.0, -0.7)):
    """bf16 r, k and v as strided (B, S, H, K) views of one wider
    projection, fp32 logw a view of a wider buffer; the draws of
    _wkv6_inputs."""
    rng = np.random.default_rng(seed)
    wide = torch.from_numpy((rng.standard_normal((b, s, 3 * h * k + 64)) * 0.5)
                            .astype(np.float32)).to(card, torch.bfloat16)
    r, kk, v = (wide[..., i * h * k:(i + 1) * h * k].unflatten(-1, (h, k))
                for i in range(3))
    lw = torch.from_numpy(-np.exp(rng.uniform(*logw_range, (b, s, h * k + 8)))
                          .astype(np.float32)).to(card)
    u = torch.from_numpy((rng.standard_normal((h, k)) * 0.3)
                         .astype(np.float32)).to(card)
    return r, kk, v, lw[..., :h * k].unflatten(-1, (h, k)), u


@pytest.mark.parametrize("s,k", WKV6_EDGE_CASES)
def test_wkv6_bf16_kernel_edges_on_model_views(card, s, k):
    r, kk, v, logw, u = _wkv6_model_views(21, 2, s, 4, k, card)
    before = wkv.wkv6_bhsk.launches
    got = ops.wkv6(r, kk, v, logw, u)
    torch.cuda.synchronize()
    assert wkv.wkv6_bhsk.launches == before + 1
    assert got.shape == r.shape and got.dtype == torch.bfloat16
    tr = lambda a: a.permute(0, 2, 1, 3)
    want = tr(wkv.wkv6_plain(tr(r), tr(kk), tr(v), tr(logw), u))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


def test_wkv6_bf16_kernel_refuses_misaligned_views(card):
    r, kk, v, logw, u = _wkv6_model_views(22, 1, 64, 2, 64, card)
    shifted = torch.zeros(1, 64, 2, 72, dtype=torch.bfloat16,
                          device=card)[..., 1:65]   # base 2 bytes off 16
    ragged = torch.zeros(1, 64, 2, 68, dtype=torch.bfloat16,
                         device=card)[..., :64]     # 136-byte head stride
    before = wkv.wkv6_bhsk.launches
    with pytest.raises(ValueError):
        ops.wkv6(shifted, kk, v, logw, u)
    with pytest.raises(ValueError):
        ops.wkv6(r, kk, ragged, logw, u)
    assert wkv.wkv6_bhsk.launches == before


def test_wkv6_bf16_call_is_one_kernel_launch(card):
    """Each bf16 call at rwkv6-7b's head width adds one to the counter and
    enqueues exactly one CUDA kernel."""
    args = _wkv6_model_views(23, 1, 300, 64, 64, card)
    ops.wkv6(*args)                             # builds
    before = wkv.wkv6_bhsk.launches
    one = _one_kernel_per_call(lambda: ops.wkv6(*args))
    assert wkv.wkv6_bhsk.launches == before + 5
    assert one


def _ssd_inputs(seed, b, s, h, p, g, n, dtype, card, strong=False):
    """tests/test_kernels.py's draws (dt = softplus(N(0,1) - 1), A =
    -exp(0.3 N(0,1))), or with ``strong`` dt in (0.1, 0.5) and A in
    (-16, -1), so dt A reaches -8 per token. dt, A and D stay fp32."""
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(card, dt)

    x = t(rng.standard_normal((b, s, h, p)) * 0.5, DTYPES[dtype])
    if strong:
        dt = t(rng.uniform(0.1, 0.5, (b, s, h)))
        A = t(-rng.uniform(1.0, 16.0, h))
    else:
        dt = t(np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0)))
        A = t(-np.exp(rng.standard_normal(h) * 0.3))
    Bm = t(rng.standard_normal((b, s, g, n)) * 0.5, DTYPES[dtype])
    Cm = t(rng.standard_normal((b, s, g, n)) * 0.5, DTYPES[dtype])
    return x, dt, A, Bm, Cm, t(np.ones(h))


@pytest.mark.parametrize("b,s,h,p,g,n", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_matches_plain(card, b, s, h, p, g, n, dtype):
    x, dt, A, Bm, Cm, D = _ssd_inputs(12, b, s, h, p, g, n, dtype, card)
    before = ssd.ssd_bhsp.launches
    got = ops.mamba2_ssd(x, dt, A, Bm, Cm, D)
    torch.cuda.synchronize()
    assert ssd.ssd_bhsp.launches == before + 1
    assert got.shape == x.shape and got.dtype == x.dtype and got.is_contiguous()
    tr = lambda a: a.permute(0, 2, 1, 3)
    want = tr(ssd.ssd_plain(tr(x), dt.permute(0, 2, 1), A, tr(Bm), tr(Cm), D))
    np.testing.assert_allclose(_np(got), _np(want),
                               **_recurrence_tol(dtype, 5e-4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_strong_decay_matches_sequential_ref(card, dtype):
    """dt A down to -8 per token: fp32 takes the scalar kernel, bf16 the
    chunked one, whose every exponent is a masked, non-positive difference;
    both stay finite and match the sequential oracle on the same inputs."""
    x, dt, A, Bm, Cm, D = _ssd_inputs(13, 1, 512, 4, 64, 1, 64, dtype,
                                      card, strong=True)
    got = ops.mamba2_ssd(x, dt, A, Bm, Cm, D)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got),
                               _np(ref.ssd_ref(x, dt, A, Bm, Cm, D)),
                               **_recurrence_tol(dtype, 5e-4))


def _ssd_model_views(seed, b, s, h, p, g, n, card):
    """bf16 x, B and C as the model hands them over: x a (B, S, H, P) view
    of the first H P columns of a wider projection, B and C the two halves
    of one (B, S, 2 G N) convolution output."""
    x, dt, A, _, _, D = _ssd_inputs(seed, b, s, h, p, g, n, "bfloat16", card)
    rng = np.random.default_rng(seed + 1)
    wide = torch.from_numpy((rng.standard_normal((b, s, h * p + 64)) * 0.5)
                            .astype(np.float32)).to(card, torch.bfloat16)
    x = wide[..., :h * p].unflatten(-1, (h, p))
    bc = torch.from_numpy((rng.standard_normal((b, s, 2 * g * n)) * 0.5)
                          .astype(np.float32)).to(card, torch.bfloat16)
    Bm = bc[..., :g * n].unflatten(-1, (g, n))
    Cm = bc[..., g * n:].unflatten(-1, (g, n))
    return x, dt, A, Bm, Cm, D


@pytest.mark.parametrize("s,p,n", SSD_EDGE_CASES)
def test_ssd_bf16_kernel_edges_on_model_views(card, s, p, n):
    x, dt, A, Bm, Cm, D = _ssd_model_views(18, 2, s, 4, p, 2, n, card)
    before = ssd.ssd_bhsp.launches
    got = ops.mamba2_ssd(x, dt, A, Bm, Cm, D)
    torch.cuda.synchronize()
    assert ssd.ssd_bhsp.launches == before + 1
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    tr = lambda a: a.permute(0, 2, 1, 3)
    want = tr(ssd.ssd_plain(tr(x), dt.permute(0, 2, 1), A, tr(Bm), tr(Cm), D))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


def test_ssd_bf16_kernel_refuses_misaligned_views(card):
    x, dt, A, Bm, Cm, D = _ssd_model_views(19, 1, 64, 2, 64, 1, 64, card)
    shifted = torch.zeros(1, 64, 2, 72, dtype=torch.bfloat16,
                          device=card)[..., 1:65]   # base 2 bytes off 16
    ragged = torch.zeros(1, 64, 1, 68, dtype=torch.bfloat16,
                         device=card)[..., :64]     # 136-byte row stride
    before = ssd.ssd_bhsp.launches
    with pytest.raises(ValueError):
        ops.mamba2_ssd(shifted, dt, A, Bm, Cm, D)
    with pytest.raises(ValueError):
        ops.mamba2_ssd(x, dt, A, ragged, Cm, D)
    assert ssd.ssd_bhsp.launches == before


def test_ssd_bf16_call_is_one_kernel_launch(card):
    """Each bf16 call at zamba2-7b's prefill width adds one to the counter
    and enqueues exactly one CUDA kernel."""
    args = _ssd_model_views(20, 1, 300, 112, 64, 1, 64, card)
    ops.mamba2_ssd(*args)                       # builds
    before = ssd.ssd_bhsp.launches
    one = _one_kernel_per_call(lambda: ops.mamba2_ssd(*args))
    assert ssd.ssd_bhsp.launches == before + 5
    assert one


def test_kernels_raise_instead_of_falling_back(card):
    q = torch.zeros(1, 8, 2, 8, dtype=torch.float16, device=card)
    with pytest.raises(TypeError):
        ops.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        ops.decode_attention(q[:, :1], q, q,
                             torch.ones(1, dtype=torch.int32, device=card))
    with pytest.raises(TypeError):
        ops.wkv6(q, q, q, q, torch.zeros(2, 8, device=card))
    h = torch.zeros(1, 8, 2, device=card)
    with pytest.raises(TypeError):
        ops.mamba2_ssd(q, h, h[0, 0], q, q, h[0, 0])


def test_kernel_launches_refuse_grad(card):
    """Each wrapper refuses CUDA inputs that require grad (its output would
    have no grad_fn) before it launches anything."""
    x = torch.randn(1, 2, 64, 64, device=card, requires_grad=True)
    h = torch.rand(1, 2, 64, device=card)
    calls = {
        "flash_attention_plain": (fa.flash_attention_bhsd, (x, x, x)),
        "decode_attention_plain": (dec.decode_attention_bhd, (
            x[:, :, 0], x, x, torch.ones(1, dtype=torch.int32, device=card))),
        "wkv6_plain": (wkv.wkv6_bhsk, (x, x, x, -x.detach().abs(),
                                       torch.zeros(2, 64, device=card))),
        "ssd_plain": (ssd.ssd_bhsp, (x, h, -h[0, :, 0], x[:, :1], x[:, :1],
                                     h[0, :, 0])),
    }
    counters = (fa.flash_attention_bhsd, dec.decode_attention_bhd,
                wkv.wkv6_bhsk, ssd.ssd_bhsp)
    before = [c.launches for c in counters]
    for plain, (fn, args) in calls.items():
        with pytest.raises(RuntimeError, match=plain):
            fn(*args)
    assert [c.launches for c in counters] == before


# the autotuner's knobs at a small shape (the reference's smoke shapes)
# and at serving-like ones (the serving widths, shorter or fewer rows)
KNOB_SHAPES = {
    "flash_attention": [
        AT.SMOKE_SHAPES["flash_attention"][0],
        {"b": 2, "s": 1024, "h": 16, "kv": 16, "d": 128, "dtype": "bfloat16"}],
    "decode_attention": [
        AT.SMOKE_SHAPES["decode_attention"][0],
        {"b": 4, "s": 1024, "h": 16, "kv": 16, "d": 128, "dtype": "bfloat16"}],
    "rwkv6": [AT.SMOKE_SHAPES["rwkv6"][0],
              {"b": 2, "s": 1024, "h": 64, "k": 64, "dtype": "bfloat16"}],
    "mamba2_ssd": [
        AT.SMOKE_SHAPES["mamba2_ssd"][0],
        {"b": 2, "s": 1024, "h": 112, "p": 64, "n": 64, "dtype": "bfloat16"}],
}
KNOB_CASES = [(k, i) for k in sorted(KNOB_SHAPES) for i in (0, 1)]


@pytest.mark.parametrize("kernel,which", KNOB_CASES)
def test_every_knob_rung_matches_plain(card, kernel, which):
    """Each rung of a kernel's ladder against the fp32 plain version within
    tests/test_kernels.py's bf16 tolerance; flash's group only orders the
    CTAs, so each group gives the default's bits."""
    spec, shape = AT.KERNELS[kernel], KNOB_SHAPES[kernel][which]
    args, want = spec.build(shape, 3, card)
    (knob, ladder), = AT.ladders_of(spec, shape).items()
    base = spec.call(AT.seed_config(spec, shape), *args)
    for value in ladder:
        assert AT.legal(spec, shape, {knob: value})
        got = spec.call({knob: value}, *args)
        torch.cuda.synchronize()
        assert AT.output_err(got, want) <= spec.tol, (knob, value)
        if kernel == "flash_attention":
            assert torch.equal(got.view(torch.int16), base.view(torch.int16))


@pytest.mark.parametrize("kernel", sorted(KNOB_SHAPES))
def test_no_knob_launches_the_default_bit_for_bit(card, kernel):
    """A call without a knob launches what the autotuner seeds at: the
    same bits as the knob set to ``seed_config``'s value."""
    spec, shape = AT.KERNELS[kernel], KNOB_SHAPES[kernel][1]
    args, _ = spec.build(shape, 4, card)
    (knob, _), = AT.ladders_of(spec, shape).items()
    none = spec.call({knob: None}, *args)
    default = spec.call(AT.seed_config(spec, shape), *args)
    torch.cuda.synchronize()
    assert torch.equal(none.view(torch.int16), default.view(torch.int16))


def test_flash_group_rule_is_the_kernels(card):
    lib = _build.load("flash_attention", fa._SIGNATURES)
    for b, s, h, kv in [(4, 2048, 16, 16), (4, 2048, 32, 32), (4, 2048, 40, 8),
                        (1, 100, 2, 1), (2, 65536, 8, 8), (1, 16, 64, 8)]:
        assert lib.flash_attention_group(b, s, h, kv) == \
            fa.default_group(b, s, h, kv)


def test_knobs_on_fp32_raise_but_decodes_split(card):
    """The fp32 flash, WKV6 and SSD kernels have no knob; decode's split
    is shared by both dtypes (up to 64 positions in fp32)."""
    counters = (fa.flash_attention_bhsd, dec.decode_attention_bhd,
                wkv.wkv6_bhsk, ssd.ssd_bhsp)
    for kernel in ("flash_attention", "rwkv6", "mamba2_ssd"):
        spec = AT.KERNELS[kernel]
        shape = dict(AT.SMOKE_SHAPES[kernel][0], dtype="float32")
        args, _ = spec.build(shape, 5, card)
        (knob, ladder), = AT.ladders_of(
            spec, AT.SMOKE_SHAPES[kernel][0]).items()
        before = [c.launches for c in counters]
        with pytest.raises(ValueError, match="only the bf16"):
            spec.call({knob: ladder[0]}, *args)
        assert [c.launches for c in counters] == before
    spec = AT.KERNELS["decode_attention"]
    shape = dict(AT.SMOKE_SHAPES["decode_attention"][0], dtype="float32")
    args, want = spec.build(shape, 5, card)
    for split in (32, 64):
        got = spec.call({"split": split}, *args)
        torch.cuda.synchronize()
        assert AT.output_err(got, want) <= 2e-5
    with pytest.raises(ValueError, match="within 1 .. 64"):
        spec.call({"split": 128}, *args)


def test_chunked_instances_on_the_card(card):
    """The 32- and 64-column instances of the bf16 WKV6 and SSD kernels:
    their shared memory, and at least the two CTAs an SM that their
    launch bounds ask for."""
    for info, smem in ((wkv.chunk_kernel_info, {32: 98304, 64: 110592}),
                       (ssd.chunk_kernel_info, {32: 64000, 64: 84480})):
        for tile, nbytes in smem.items():
            got = info(tile, card)
            assert got["smem_bytes"] == nbytes
            assert got["ctas_per_sm"] >= 2 and got["registers"] <= 255


@pytest.mark.parametrize("kernel", sorted(KNOB_SHAPES))
def test_autotune_on_the_card_picks_a_winner_within_tol(card, kernel):
    shape = AT.SMOKE_SHAPES[kernel][0]
    entry = AT.autotune(kernel, shape, device=card)
    assert entry["mode"] == "cuda"
    assert entry["family"] == torch.cuda.get_device_name(card)
    assert entry["max_err"] <= entry["tol"]
    assert entry["default_config"] == AT.seed_config(AT.KERNELS[kernel],
                                                     shape)
    assert entry["us"] > 0 and entry["roofline_fraction"] > 0


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-8b", "olmoe-1b-7b"])
def test_reduced_train_step_on_card_matches_cpu(card, arch):
    """fp32 loss and gradients of the reduced model on the card against the
    CPU (GQA and qk-norm with qwen3-8b; S = 1040 takes the chunked
    attention), then two AdamW steps. The gradients sum the same products
    in other orders: rtol 1e-4, atol 1e-5. The params may differ by a
    sign flip of an update of size lr per step, so 4 lr after two."""
    cfg = get_arch(arch).reduced()
    tc = T.TrainConfig(remat="full", compute_dtype="float32")
    oc = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    rng = np.random.default_rng(4)
    batches = [{k: rng.integers(0, cfg.vocab_size, (1, 1040)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(2)]
    runs = []
    for dev in ("cpu", card):
        params = _to(M.init_params(cfg, 0, device="cpu"), dev)
        loss, _, grads = T.make_grad_fn(cfg, tc, device=dev)(
            params, {k: torch.from_numpy(v).to(dev)
                     for k, v in batches[0].items()})
        step = T.make_train_step(cfg, tc, oc, device=dev)
        opt = T.make_opt_state(params, tc)
        for b in batches:
            params, opt, metrics = step(params, opt, b)
        runs.append((float(loss), grads, params, float(metrics["loss"])))
    (cl, cg, cp, cm), (gl, gg, gp, gm) = runs
    assert gl == pytest.approx(cl, rel=1e-5)
    assert gm == pytest.approx(cm, rel=1e-4)
    for on_cpu, on_card, tol in ((cg, gg, dict(rtol=1e-4, atol=1e-5)),
                                 (cp, gp, dict(rtol=0, atol=4e-3))):
        want, got = convert.flatten(on_cpu), convert.flatten(on_card)
        for key in want:
            np.testing.assert_allclose(_np(got[key]), _np(want[key]),
                                       err_msg=key, **tol)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-8b", "rwkv6-7b",
                                  "zamba2-7b", "olmoe-1b-7b",
                                  "llama4-scout-17b-a16e"])
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


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "musicgen-large"])
def test_reduced_media_model_on_card_matches_cpu(card, arch):
    """Reduced llama-3.2-vision-11b (its cross-attention gates set to 1, so
    the vision states count) and musicgen-large (4 codebooks), fp32, on the
    card (flash and decode kernels) against the CPU (plain versions): the
    prefill step's logits, and the serve step's logits over 6 teacher-forced
    tokens with the vision K/V in the decode state."""
    cfg = get_arch(arch).reduced()
    cpu = M.init_params(cfg, 0, device="cpu")
    if cfg.family == "vlm":
        for gate in ("gate_attn", "gate_mlp"):
            cpu["layers"]["single"][gate].fill_(1.0)
    gpu = _to(cpu, card)
    rng = np.random.default_rng(1)
    books = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 37, *books)))
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["vision"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_vision_tokens, cfg.vision_dim)).astype(np.float32))
    outs = []
    for params, dev in ((cpu, "cpu"), (gpu, card)):
        pre = D.make_prefill_step(cfg, compute_dtype=torch.float32, device=dev)
        outs.append(_np(pre(params, batch)))
        step = D.make_serve_step(cfg, 8, compute_dtype=torch.float32,
                                 device=dev)
        states = TF.init_decode_state(cfg, 2, 8, dtype=torch.float32,
                                      device=dev, vision=batch.get("vision"),
                                      params=params)
        for t in range(6):
            logits, states, _ = step(params, states, {
                "tokens": toks[:, t:t + 1],
                "cache_len": torch.full((2,), t, dtype=torch.int32)})
        outs.append(_np(logits))
    np.testing.assert_allclose(outs[2], outs[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(outs[3], outs[1], rtol=1e-4, atol=1e-4)


def test_checkpoint_round_trip_on_card(card, tmp_path):
    """CUDA leaves (fp32, bf16, the int32 step, a zero-size sentinel) saved
    and restored: they come back on the card in their dtypes, bit-equal,
    in memory of their own, and an in-place AdamW step on the restored
    state leaves the live state as it was."""
    gen = torch.Generator(device=card).manual_seed(0)
    params = {"w": torch.randn(64, 32, generator=gen, device=card),
              "b": torch.randn(32, generator=gen, device=card).bfloat16(),
              "norm": {"_np": torch.zeros(0, device=card)}}

    def moments():
        return {"w": torch.randn(64, 32, generator=gen, device=card),
                "b": torch.randn(32, generator=gen, device=card),
                "norm": {"_np": torch.zeros(0, device=card)}}

    opt = {"mu": moments(), "nu": moments(),
           "step": torch.tensor(3, dtype=torch.int32, device=card)}
    opt["nu"] = tree_map(torch.abs, opt["nu"])
    live = {"params": params, "opt": opt}
    ckpt = CheckpointManager(AcaiProject("p", tmp_path), "run")
    ckpt.save(3, params, opt, extra={"loss": 1.0})
    state, step = ckpt.restore(live)
    assert step == 3
    got, want = convert.flatten(state), convert.flatten(live)
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        assert (g.device, g.dtype, g.shape) == (w.device, w.dtype, w.shape)
        assert g.numel() == 0 or g.data_ptr() != w.data_ptr(), key
        if g.numel():
            assert torch.equal(g.reshape(-1).view(torch.uint8),
                               w.reshape(-1).view(torch.uint8)), key
    before = {k: v.clone() for k, v in want.items()}
    adamw_update(OptimizerConfig(lr=0.1, warmup_steps=0), state["params"],
                 tree_map(torch.ones_like, state["params"]), state["opt"])
    assert int(state["opt"]["step"]) == 4
    for key, w in want.items():
        assert torch.equal(w, before[key]), key


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _spin_ms(cycles):
    """The device time of one ``torch.cuda._sleep(cycles)``, from events."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(cycles)            # warm-up
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def test_thread_runner_runtime_covers_queued_device_work(card, tmp_path):
    """A job on a worker thread enqueues a spin and returns without a
    sync: its engine runtime and bill still cover the spin, because the
    runner waits for the card before it reads the end time."""
    cycles = 200_000_000
    spin_ms = _spin_ms(cycles)
    assert spin_ms > 20
    eng = AcaiEngine(runner="thread", max_workers=1, workroot=str(tmp_path))
    seen = {}

    def job_fn(workdir, job):
        t0 = time.perf_counter()
        torch.cuda._sleep(cycles)
        seen["thread"] = threading.current_thread().name
        seen["enqueue_ms"] = 1e3 * (time.perf_counter() - t0)

    h = eng.submit(JobSpec(name="spin", project="p", user="u", fn=job_fn,
                           resources={"vcpu": 1, "mem_mb": 512}))
    assert h.wait(timeout=120).value == "FINISHED", h.job.error
    job = h.job
    assert seen["thread"].startswith("acai-agent")
    assert seen["enqueue_ms"] < spin_ms / 2
    assert 1e3 * job.runtime >= spin_ms
    assert job.cost > 0
    eng.launcher.shutdown()


def test_subprocess_runner_runtime_covers_queued_device_work(card, tmp_path):
    """A job in the subprocess runner's worker process enqueues a spin and
    returns without a sync: its engine runtime and bill still cover the
    spin, because the worker waits for the job's stream before it reads
    the end time (the reference's worker reads it at once; ROADMAP C). A
    probe job first initialises CUDA in the worker and finds the kernel
    libraries built, so the spin job runs on a stream of its own, not the
    default stream."""
    from repro_torch.examples import card_jobs as CJ
    cycles = 400_000_000
    spin_ms = _spin_ms(cycles)
    assert spin_ms > 100
    _build.build()
    eng = AcaiEngine(runner="subprocess", workroot=str(tmp_path / "w"))
    spec = dict(project="p", user="u", resources={"vcpu": 1, "mem_mb": 512})
    try:
        probe = eng.submit(JobSpec(name="probe", fn=CJ.probe_job, **spec))
        assert probe.wait(timeout=300).value == "FINISHED", probe.job.error
        h = eng.submit(JobSpec(name="spin", fn=CJ.cuda_sleep_job,
                               args={"cycles": cycles}, **spec))
        assert h.wait(timeout=300).value == "FINISHED", h.job.error
        pid = eng.launcher._worker_pid()
    finally:
        eng.launcher.shutdown()
    out = h.job.outputs
    assert probe.job.outputs["pid"] == pid != os.getpid()
    assert out["stream"] != out["default_stream"]
    assert out["enqueue_ms"] < spin_ms / 2
    assert 1e3 * h.job.runtime >= spin_ms
    assert h.job.cost > 0


def test_thread_workers_time_their_own_streams(card, tmp_path):
    """Two workers: one job leaves a long spin queued on its worker's
    stream and returns; the other, started while the spin is queued, runs
    a short elementwise kernel on its own worker's stream. The short job's
    runtime excludes the spin, the long job's covers it, and each ran on a
    stream of its own, not the default stream. Two warm-up jobs, held
    together by a barrier so that each worker runs one, first make each
    worker's stream and its cached memory (a device allocation during the
    spin could wait for it)."""
    cycles = 400_000_000
    spin_ms = _spin_ms(cycles)
    assert spin_ms > 100
    eng = AcaiEngine(runner="thread", max_workers=2, workroot=str(tmp_path))
    spec = dict(project="p", user="u", resources={"vcpu": 1, "mem_mb": 512})
    x = torch.ones(256, 256, device=card)
    both, queued, streams = threading.Barrier(2), threading.Event(), {}

    def warm_up(workdir, job):
        both.wait(60)
        (x * 2).sum()

    def long_job(workdir, job):
        streams["long"] = torch.cuda.current_stream().cuda_stream
        torch.cuda._sleep(cycles)
        queued.set()

    def short_job(workdir, job):
        assert queued.wait(60)
        streams["short"] = torch.cuda.current_stream().cuda_stream
        (x * 2).sum()

    for h in [eng.submit(JobSpec(name=f"warm-{i}", fn=warm_up, **spec))
              for i in range(2)]:
        assert h.wait(timeout=120).value == "FINISHED", h.job.error
    h_long = eng.submit(JobSpec(name="long", fn=long_job, **spec))
    h_short = eng.submit(JobSpec(name="short", fn=short_job, **spec))
    assert h_short.wait(timeout=120).value == "FINISHED", h_short.job.error
    assert h_long.wait(timeout=120).value == "FINISHED", h_long.job.error
    default = torch.cuda.default_stream().cuda_stream
    assert len({streams["long"], streams["short"], default}) == 3
    assert 1e3 * h_short.job.runtime < spin_ms / 2
    assert 1e3 * h_long.job.runtime >= spin_ms
    eng.launcher.shutdown()


def test_job_output_freed_on_the_default_stream_is_not_reused_early(
        card, tmp_path):
    """A job's result tensor was made on its worker's stream. The caller
    reads it on the default stream behind a long spin and frees it while a
    second job on the same worker (one worker) is already running; that job
    then makes a tensor of the same size and fills it. The caller's read
    still sees the first job's values: the runner marked the result as used
    by the default stream, so the worker stream's pool does not hand the
    memory out again before that read has run."""
    n = 1 << 20
    torch.ones(1, device=card)          # CUDA initialised: workers' streams
    eng = AcaiEngine(runner="thread", max_workers=1, workroot=str(tmp_path))
    spec = dict(project="p", user="u", resources={"vcpu": 1, "mem_mb": 512})
    started, freed = threading.Event(), threading.Event()

    def make(workdir, job):
        assert torch.cuda.current_stream() != torch.cuda.default_stream()
        return {"out": torch.full((n,), 1.0, device=card)}

    def overwrite(workdir, job):
        started.set()
        assert freed.wait(60)
        torch.full((n,), 2.0, device=card)

    h = eng.submit(JobSpec(name="make", fn=make, **spec))
    out = h.result(timeout=120)["out"]
    h.job.outputs.pop("out")
    h2 = eng.submit(JobSpec(name="overwrite", fn=overwrite, **spec))
    assert started.wait(60)
    torch.cuda._sleep(400_000_000)      # the default stream is busy ...
    seen = out.clone()                  # ... and reads out after the spin
    del out
    freed.set()
    assert h2.wait(timeout=120).value == "FINISHED", h2.job.error
    torch.cuda.synchronize()
    assert bool((seen == 1.0).all())
    eng.launcher.shutdown()


def test_decode_on_two_streams_at_once(card):
    """Two streams decode different inputs at once, at a shape that splits
    each row over several CTAs (a 1024 buffer: 8 splits, merged through
    the tickets): each output equals its one-stream output bit for bit, so
    the two streams' launches never count on one ticket buffer."""
    shapes = [(4, 1, 16, 128), (4, 1024, 16, 128), (4, 1024, 16, 128)]
    inputs = [_randn(seed, shapes, "bfloat16", card) for seed in (40, 41)]
    lens = torch.tensor([1024, 900, 700, 1000], dtype=torch.int32, device=card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert 1024 // dec.split_size(1024, 4 * 16, 2, sms) > 1
    want = [ops.decode_attention(*ins, lens) for ins in inputs]
    streams = [torch.cuda.Stream() for _ in inputs]
    got = [[], []]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for st in streams:                 # both start behind a spin, together
        with torch.cuda.stream(st):
            torch.cuda._sleep(50_000_000)
    for _ in range(20):
        for i, (st, ins) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(st):
                got[i].append(ops.decode_attention(*ins, lens))
    torch.cuda.synchronize()
    for i in range(2):
        for out in got[i]:
            assert torch.equal(out, want[i])


def test_moe_decode_tick_makes_no_host_sync(card):
    """One decode tick of reduced olmoe-1b-7b and llama4-scout on the card
    under ``torch.cuda.set_sync_debug_mode("error")``: routing, capacity,
    dispatch and combine read nothing back to the host and take no shape
    from the data (as a CUDA graph would need). The tick's context is made
    before, since ``make_ctx`` checks the positions on the host."""
    for arch in ("olmoe-1b-7b", "llama4-scout-17b-a16e"):
        cfg = get_arch(arch).reduced()
        params = M.init_params(cfg, 0, device=card)
        states = TF.init_decode_state(cfg, 4, 16, device=card)
        tokens = torch.tensor([[1], [2], [3], [4]], device=card)
        cache_len = torch.tensor([0, 3, 5, 7], dtype=torch.int32, device=card)
        ctx = M.make_ctx(cfg, 16, "decode", cache_len=cache_len, device=card)
        M.decode_step(params, tokens, states, cache_len, cfg, ctx)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits, _ = M.decode_step(params, tokens, states, cache_len, cfg,
                                      ctx)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert logits.shape == (4, 1, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())


def test_kernels_launch_from_an_agent_thread(card, tmp_path):
    """The flash and decode kernels' first load in this process (and their
    build, when the library is missing) and their launches happen on an
    engine worker thread; the results match the plain versions and the
    launch counters move by one each."""
    for name in ("flash_attention", "decode_attention"):
        _build._libs.pop(name, None)
    q, k, v = _randn(11, [(2, 256, 4, 64), (2, 256, 2, 64), (2, 256, 2, 64)],
                     "bfloat16", card)
    qd, kc, vc = _randn(12, [(2, 1, 4, 64), (2, 512, 2, 64), (2, 512, 2, 64)],
                        "bfloat16", card)
    lens = torch.tensor([100, 512], dtype=torch.int32, device=card)
    before = (fa.flash_attention_bhsd.launches,
              dec.decode_attention_bhd.launches)
    eng = AcaiEngine(runner="thread", max_workers=1, workroot=str(tmp_path))

    def job_fn(workdir, job):
        got = {"flash": ops.flash_attention(q, k, v, causal=True),
               "decode": ops.decode_attention(qd, kc, vc, lens)}
        print(f"[[acai:thread={threading.current_thread().name}]]")
        return {name: t.float().cpu() for name, t in got.items()}

    h = eng.submit(JobSpec(name="kernels", project="p", user="u",
                           fn=job_fn))
    out = h.result(timeout=600)
    assert "acai-agent" in out["log"]
    assert (fa.flash_attention_bhsd.launches,
            dec.decode_attention_bhd.launches) == (before[0] + 1,
                                                   before[1] + 1)
    assert set(_build._libs) >= {"flash_attention", "decode_attention"}
    want = fa.flash_attention_plain(*(t.permute(0, 2, 1, 3) for t in (q, k, v)),
                                    causal=True).permute(0, 2, 1, 3)
    np.testing.assert_allclose(out["flash"].numpy(), _np(want),
                               **_tol("bfloat16"))
    want = dec.decode_attention_plain(qd[:, 0], kc.permute(0, 2, 1, 3),
                                      vc.permute(0, 2, 1, 3), lens)
    np.testing.assert_allclose(out["decode"][:, 0].numpy(), _np(want),
                               **_tol("bfloat16"))
    eng.launcher.shutdown()


# ---------------------------------------------------------------------------
# the train path's scans: plain torch on the card, no kernel
# ---------------------------------------------------------------------------


def _scan_case(scan, seed, card, dtype="float32", full_width=False):
    """Inputs, the train-mode scan, its sequential oracle and its kernel's
    wrapper. Small shapes with a ragged S, or one sequence of 256 at the
    full configs' head shapes (rwkv6-7b: 64 heads of 64; zamba2-7b: 112
    heads of 64, one group, state 64)."""
    if scan == "wkv6":
        b, s, h, k = (1, 256, 64, 64) if full_width else (2, 601, 2, 32)
        return (list(_wkv6_inputs(seed, b, s, h, k, dtype, card)),
                R.wkv6_chunked, ref.wkv6_ref, ops.wkv6)
    b, s, h, p, g, n = (1, 256, 112, 64, 1, 64) if full_width \
        else (2, 601, 4, 32, 2, 16)
    return (list(_ssd_inputs(seed, b, s, h, p, g, n, dtype, card)),
            MB.ssd_chunked, ref.ssd_ref, ops.mamba2_ssd)


@pytest.mark.parametrize("scan", ["ssd", "wkv6"])
def test_train_scan_and_grads_match_sequential_ref_on_card(card, scan):
    """fp32 output and the gradients of every input of ``wkv6_chunked`` and
    ``ssd_chunked`` on the card against autograd through kernels/ref.py's
    sequential oracles, at S = 601: fp32 sums in other orders, within 5e-5
    of each one's largest entry (on the CPU, at most 4.2e-6)."""
    args, chunked, oracle, _ = _scan_case(scan, 30, card)
    gen = torch.Generator(device=card).manual_seed(0)
    ct = torch.randn(args[0].shape, generator=gen, device=card)
    outs = []
    for fn in (chunked, oracle):
        ins = [a.detach().clone().requires_grad_() for a in args]
        y = fn(*ins)
        outs.append([y.detach(), *torch.autograd.grad(y, ins, ct)])
    for i, (got, want) in enumerate(zip(*outs)):
        assert bool(torch.isfinite(got).all()), i
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, err_msg=i,
                                   atol=5e-5 * want.abs().max().item())


@pytest.mark.parametrize("scan", ["ssd", "wkv6"])
def test_train_scan_bf16_matches_kernel_at_full_width_heads(card, scan):
    """The bf16 forward of the train-mode scan against the CUDA kernel
    that prefill runs, on the same bf16 inputs at the full configs' head
    shapes, at the kernels' bf16 tolerance."""
    args, chunked, _, kernel = _scan_case(scan, 31, card, "bfloat16",
                                          full_width=True)
    got, want = chunked(*args), kernel(*args)
    assert got.dtype == want.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **_tol("bfloat16"))


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_recurrent_train_step_launches_no_kernel(card, arch):
    """A train step of the reduced rwkv6-7b or zamba2-7b on the card runs
    its scans and its shared attention in plain torch: no launch counter
    moves, and the loss is finite."""
    cfg = get_arch(arch).reduced()
    counters = (fa.flash_attention_bhsd, dec.decode_attention_bhd,
                wkv.wkv6_bhsk, ssd.ssd_bhsp)
    before = [c.launches for c in counters]
    tc = T.TrainConfig(remat="full")
    params = M.init_params(cfg, 0, device=card)
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 200)).astype(np.int32)
             for k in ("tokens", "labels")}
    _, _, metrics = T.make_train_step(cfg, tc, OptimizerConfig(), device=card)(
        params, T.make_opt_state(params, tc), batch)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == before
    assert np.isfinite(float(metrics["loss"]))


def test_two_ranks_sharing_the_card_run_the_kernels_at_their_heads(
        card, tmp_path):
    """Two ranks on gloo share the card on a (1, 2) mesh (olmo-1b at full
    width, 2 layers, fp32): the sharded prefill launches the flash kernel
    once a layer and the sharded tick the decode kernel once a layer, each
    rank at 8 of the 16 heads (per-rank launch counters), and the global
    logits match the one-device plain versions on the CPU."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_mesh_ranks as TR
    npz, meta = TR.spawn("card", 2, tmp_path, timeout=600)
    for rank in meta["card"]:
        assert rank["launches"] == {"flash": 2, "decode": 16}
        assert rank["heads"] == {"flash": [8], "decode": [8]}
    for what in ("prefill", "decode"):
        got, want = npz[f"card/{what}"], npz[f"card/{what}_plain"]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-3 * (want.max() - want.min())


def test_two_ranks_on_the_card_decode_a_kv_sequence_sharded_over_model(
        card, tmp_path):
    """Two ranks on gloo share the card on a (1, 2) mesh: reduced qwen3-8b's
    one kv head makes its KV sequence shard over model, so each rank
    gathers q to every head and runs the decode kernel's partial softmax
    over its half of the buffer, once a layer a tick; 40 fp32 ticks from an
    empty cache cross the ranks' edge at 32 of 64 positions, so that the
    later ticks weigh both ranks' pieces. The global logits match the
    one-device plain version on the CPU within 1e-5 of their range."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_mesh_ranks as TR
    npz, meta = TR.spawn("card_kv", 2, tmp_path, timeout=600)
    for rank in meta["card_kv"]:
        assert rank["kv_spec"][2] == "model", rank
        assert rank["launches"] == rank["layers"] * TR.CARD_KV_TICKS
        assert rank["calls"] == [[rank["n_heads"], TR.CARD_KV_BUF // 2,
                                  True]]
    got, want = npz["card_kv/decode"], npz["card_kv/decode_plain"]
    assert got.shape == want.shape
    for t in range(TR.CARD_KV_TICKS):
        span = want[:, t].max() - want[:, t].min()
        assert np.abs(got[:, t] - want[:, t]).max() <= 1e-5 * span, t


def test_two_ranks_on_the_card_take_the_loss_over_vocab_shards(card,
                                                               tmp_path):
    """Two ranks on gloo share the card on a (1, 2) mesh, fp32, reduced
    olmo-1b (a tied table), qwen3-8b (an untied head) and musicgen-large
    at 4 and 3 codebooks (a rank's columns split a codebook at 3): the
    sharded loss (each rank its vocab columns, the row max and sums
    all-reduced through host memory) equals the gathered path's value on
    each rank (the columns gathered whole, then the whole softmax) at
    rtol 1e-6, and the loss and every gradient equal the one-device
    step's on the card at rtol 1e-4, atol 1e-5."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax_mesh_reference as JR
    import torch_mesh_ranks as TR
    npz, meta = TR.spawn("card_loss", 2, tmp_path, timeout=600)
    tol = dict(rtol=1e-4, atol=1e-5)
    for key in JR.LOSS_CONFIGS:
        cfg = JR.loss_config(key, get_arch)
        loss = float(npz[f"card_loss/{key}/loss"])
        for rank in meta["card_loss"][key]:
            assert rank["logits_shape"][-1] == cfg.vocab_size
            assert rank["gathered"] == pytest.approx(loss, rel=1e-6)
        np.testing.assert_allclose(loss, npz[f"card_loss/{key}/one_loss"],
                                   **tol)
        prefix = f"card_loss/{key}/one_grad/"
        keys = [k[len(prefix):] for k in npz.files if k.startswith(prefix)]
        assert keys
        for k in keys:
            np.testing.assert_allclose(npz[f"card_loss/{key}/grad/{k}"],
                                       npz[prefix + k], err_msg=k, **tol)


def test_two_ranks_on_the_card_gather_fsdp_per_layer_and_serve_on_a_pod(
        card, tmp_path):
    """Two ranks on gloo share the card, reduced olmo-1b, fp32: on (2, 1)
    the sharded gradient (FSDP gathers each layer over data where it runs,
    remat full) equals the one-device step's loss and gradients on the
    card at rtol 1e-4, atol 1e-5; on (2, 1, 1) ("pod", "data", "model") the
    batch goes over "pod" (2 of 4 rows a rank), each rank launches the
    decode kernel once a layer a tick, and 8 teacher-forced ticks' logits
    equal the one-device port's on the card within 1e-5 of their range."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_mesh_ranks as TR
    npz, meta = TR.spawn("card_pod", 2, tmp_path, timeout=600)
    for rank in meta["card_pod"]:
        assert rank["launches"] == rank["layers"] * TR.CARD_POD_TICKS
        assert rank["local_batch"][1] == 2, rank          # (L, B, S, KV, D)
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(npz["card_pod/loss"],
                               npz["card_pod/one_loss"], **tol)
    keys = [k[len("card_pod/grad/"):] for k in npz.files
            if k.startswith("card_pod/grad/")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(npz[f"card_pod/grad/{k}"],
                                   npz[f"card_pod/one_grad/{k}"], err_msg=k,
                                   **tol)
    got, want = npz["card_pod/decode"], npz["card_pod/decode_one"]
    assert got.shape == want.shape
    for t in range(TR.CARD_POD_TICKS):
        span = want[:, t].max() - want[:, t].min()
        assert np.abs(got[:, t] - want[:, t]).max() <= 1e-5 * span, t


# -- the dry-run on the card -------------------------------------------------
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_a_dry_run_counts_the_same_on_fake_cuda_and_fake_cpu_tensors(card,
                                                                    kind):
    """Reduced olmo-1b's cell of ``kind`` (8 rows of 128 tokens) on a fake
    (2, 2) mesh: every field that the program fixes (FLOPs, bytes, fused
    bytes, collectives by kind, the kernel records) is the same whether
    the fake tensors are CUDA tensors or CPU tensors."""
    cfg, shape = get_arch("olmo-1b").reduced(), ShapeConfig(kind, 128, 8,
                                                            kind)
    counts = [DR.count_cell(cfg, shape, (2, 2), tcfg=T.TrainConfig(),
                            device=dev)["cost"].program()
              for dev in ("cuda", "cpu")]
    assert counts[0] == counts[1]
    assert counts[0]["flops"] > 0
    assert bool(counts[0]["kernels"]) == (kind != "train")


def _kernel_calls(dev):
    """One call of each adapter on seeded bf16 inputs on ``dev`` at shapes
    the kernels take, with each wrapper."""
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    b, s, h, d = 1, 128, 2, 64
    q, k, v = (r(b, s, h, d).to(bf) for _ in range(3))
    clen = torch.full((b,), s // 2, dtype=torch.int32, device=dev)
    logw = -torch.exp(r(b, s, h, d) - 3)
    u = r(h, d)
    x = r(b, s, h, d).to(bf)
    dt = torch.nn.functional.softplus(r(b, s, h))
    A, D = -torch.exp(r(h)), torch.ones(h, device=dev)
    Bm, Cm = (r(b, s, 1, 16).to(bf) for _ in range(2))
    return [(lambda: ops.flash_attention(q, k, v), fa.flash_attention_bhsd),
            (lambda: ops.decode_attention(q[:, :1], k, v, clen),
             dec.decode_attention_bhd),
            (lambda: ops.wkv6(q, k, v, logw, u), wkv.wkv6_bhsk),
            (lambda: ops.mamba2_ssd(x, dt, A, Bm, Cm, D), ssd.ssd_bhsp)]


def test_a_real_tensor_never_takes_the_fake_branch(card):
    """Real CUDA tensors launch each kernel and bump its counter, with no
    count running and under a count (which then records no kernel: the
    launch is real); fake CUDA tensors outside a count raise and bump
    nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    for call, wrapper in _kernel_calls(card):
        before = wrapper.launches
        call()
        with op_cost.counting() as cost:
            call()
        torch.cuda.synchronize()
        assert wrapper.launches == before + 2
        assert not cost.kernels
    with FakeTensorMode():
        for call, wrapper in _kernel_calls(card):
            before = wrapper.launches
            with pytest.raises(RuntimeError, match="outside a count"):
                call()
            assert wrapper.launches == before
