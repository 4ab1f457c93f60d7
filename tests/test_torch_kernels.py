"""The port's kernels against the JAX package: each plain version against
``repro.kernels.ref``, the Pallas kernel in interpret mode and (for WKV6 and
SSD) the reference model's chunked jnp path, on the shape sets of
``tests/test_kernels.py``; and where the reference breaks (strong decay,
ragged lengths), against the port's own sequential oracles. The CUDA kernels
are held against their plain versions in ``test_torch_card.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models.mamba import ssd_chunked  # noqa: E402
from repro.models.rwkv import wkv6_chunked  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba2_ssd as ssd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import wkv6 as wkv  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FLASH_SHAPES = [(1, 256, 4, 4, 64),      # MHA
                (2, 256, 4, 2, 32),      # GQA 2:1
                (1, 512, 8, 2, 64),      # GQA 4:1, more blocks
                (1, 128, 2, 1, 128)]     # MQA, single block
RAGGED_SHAPES = [(1, 192, 2, 2, 80), (2, 320, 4, 2, 96), (1, 100, 2, 1, 64)]
DECODE_SHAPES = [(2, 512, 4, 2, 64), (1, 1024, 8, 8, 32)]


def _tol(dtype):
    """Tolerances of tests/test_kernels.py: bf16 keeps 8 bits of mantissa."""
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, shapes, dtype="float32"):
    """The same values for both packages: numpy fp32, then each framework
    rounds to the dtype (both round to nearest even)."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _np(x):
    return np.asarray(x.float()) if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# flash attention: plain version vs ref.py and the Pallas kernel
# ---------------------------------------------------------------------------


def _flash_case(b, s, h, kv, d, dtype, causal, seed=0):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        seed, [(b, s, h, d), (b, s, kv, d), (b, s, kv, d)], dtype)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == (b, s, h, d) and got.dtype == tq.dtype
    tol = _tol(dtype)
    np.testing.assert_allclose(
        _np(got), _np(jref.attention_ref(jq, jk, jv, causal=causal)), **tol)
    np.testing.assert_allclose(
        _np(got), _np(jops.flash_attention(jq, jk, jv, causal=causal,
                                           interpret=True)), **tol)


@pytest.mark.parametrize("b,s,h,kv,d", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_ref_and_pallas(b, s, h, kv, d, dtype):
    _flash_case(b, s, h, kv, d, dtype, causal=True)


def test_flash_plain_noncausal():
    _flash_case(1, 256, 2, 2, 64, "float32", causal=False, seed=1)


@pytest.mark.parametrize("b,s,h,kv,d", RAGGED_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_ragged_shapes(b, s, h, kv, d, causal):
    _flash_case(b, s, h, kv, d, "float32", causal=causal, seed=5)


@pytest.mark.parametrize("blocks", [(64, 64), (128, 64), (64, 128)])
def test_flash_plain_matches_pallas_block_shapes(blocks):
    """The Pallas kernel's block sizes are a scheduling choice: the port's
    result (which has no block parameter) matches every one of them."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        2, [(1, 256, 2, 32), (1, 256, 2, 32), (1, 256, 2, 32)])
    got = ops.flash_attention(tq, tk, tv)
    want = jops.flash_attention(jq, jk, jv, block_q=blocks[0],
                                block_k=blocks[1], interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_port_attention_ref_matches_jax_ref(causal):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        2, [(2, 96, 4, 32), (2, 96, 2, 32), (2, 96, 2, 32)])
    np.testing.assert_allclose(
        _np(ref.attention_ref(tq, tk, tv, causal=causal)),
        _np(jref.attention_ref(jq, jk, jv, causal=causal)),
        rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# decode attention: plain version vs ref.py, the Pallas kernel and the
# model's einsum path
# ---------------------------------------------------------------------------


def _lens(seed, b, s):
    return np.random.default_rng(seed + 100).integers(1, s, b).astype(np.int32)


@pytest.mark.parametrize("b,s,h,kv,d", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_ref_pallas_and_blocks(b, s, h, kv, d, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        0, [(b, 1, h, d), (b, s, kv, d), (b, s, kv, d)], dtype)
    lens = _lens(0, b, s)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert got.shape == (b, 1, h, d) and got.dtype == tq.dtype
    jl = jnp.asarray(lens)
    tol = _tol(dtype)
    want_ref = jref.decode_attention_ref(
        jq[:, 0], jnp.swapaxes(jk, 1, 2), jnp.swapaxes(jv, 1, 2), jl)
    np.testing.assert_allclose(_np(got[:, 0]), _np(want_ref), **tol)
    want_pallas = jops.decode_attention(jq, jk, jv, jl, block_k=256,
                                        interpret=True)
    np.testing.assert_allclose(_np(got), _np(want_pallas), **tol)
    np.testing.assert_allclose(
        _np(got), _np(JB.decode_attention(jq, jk, jv, jl)), **tol)


def test_decode_plain_ragged_cache_length():
    """A cache length no block size divides (the Pallas kernel asserts
    S % block_k == 0; the port masks instead)."""
    b, s, h, kv, d = 3, 300, 4, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        3, [(b, h, d), (b, kv, s, d), (b, kv, s, d)])
    lens = np.array([1, 150, 300], np.int32)
    got = dec.decode_attention_bhd(tq, tk, tv, torch.from_numpy(lens))
    want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens))
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_decode_plain_empty_row_gives_zeros():
    """A row with no valid position is zero. (The Pallas kernel's finite
    -1e30 mask weights every position equally there and returns the mean of
    all of V; the jnp oracle returns NaN. The model never asks: it attends
    over cache_len + 1 >= 1 positions.) Other rows are unaffected."""
    b, s, h, kv, d = 2, 512, 2, 1, 32
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        4, [(b, 1, h, d), (b, s, kv, d), (b, s, kv, d)])
    lens = np.array([0, 7], np.int32)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert torch.all(got[0] == 0)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(lens), block_k=256,
                                 interpret=True)
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(_np(want[0, 0, 0]),
                               _np(jnp.mean(jv[0, :, 0], axis=0)),
                               rtol=2e-5, atol=2e-5)


def test_port_decode_ref_matches_jax_ref():
    b, s, h, kv, d = 2, 64, 4, 2, 16
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        6, [(b, h, d), (b, kv, s, d), (b, kv, s, d)])
    lens = _lens(6, b, s)
    np.testing.assert_allclose(
        _np(ref.decode_attention_ref(tq, tk, tv, torch.from_numpy(lens))),
        _np(jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens))),
        rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# WKV6: plain version vs ref.py, the Pallas kernel and wkv6_chunked
# ---------------------------------------------------------------------------

WKV6_SHAPES = [(1, 128, 2, 32), (2, 256, 4, 64), (1, 64, 1, 16)]
SSD_SHAPES = [(1, 128, 2, 32, 1, 16), (2, 256, 4, 64, 2, 32),
              (1, 64, 2, 16, 1, 8)]


def _wkv6_inputs(seed, b, s, h, k, logw=None):
    """tests/test_kernels.py's distributions: r, k, v ~ 0.5 N(0, 1), u ~
    0.3 N(0, 1), logw = -exp(U(-7, -0.7)) (RWKV's decay range) unless given.
    Returns numpy arrays (fed to JAX) and tensors (fed to the port)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, s, h, k)).astype(np.float32) * 0.5
              for _ in range(3)]
    if logw is None:
        logw = -np.exp(rng.uniform(-7.0, -0.7, (b, s, h, k)))
    arrays.append(np.broadcast_to(logw, (b, s, h, k)).astype(np.float32))
    arrays.append((rng.standard_normal((h, k)) * 0.3).astype(np.float32))
    return arrays, [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,s,h,k", WKV6_SHAPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_wkv6_plain_matches_ref_pallas_and_chunked(b, s, h, k, seed):
    js, ts = _wkv6_inputs(seed, b, s, h, k)
    got = ops.wkv6(*ts)
    assert got.shape == (b, s, h, k) and got.dtype == torch.float32
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(got), _np(jref.wkv6_ref(*js)), **tol)
    np.testing.assert_allclose(
        _np(got), _np(jops.wkv6(*js, chunk=64, interpret=True)), **tol)
    np.testing.assert_allclose(_np(got), _np(wkv6_chunked(*js, chunk=32)),
                               **tol)


def test_port_wkv6_ref_matches_jax_ref():
    js, ts = _wkv6_inputs(2, 2, 40, 2, 16)
    np.testing.assert_allclose(_np(ref.wkv6_ref(*ts)), _np(jref.wkv6_ref(*js)),
                               rtol=1e-5, atol=1e-5)


def test_wkv6_ragged_length():
    """S = 601 at the model's chunk of 256: the reference's wkv6_chunked
    cannot reshape it; the port's plain version (which takes any S) matches
    the sequential oracle."""
    js, ts = _wkv6_inputs(3, 1, 601, 2, 16)
    with pytest.raises((TypeError, ValueError)):
        wkv6_chunked(*js, chunk=256)
    np.testing.assert_allclose(_np(ops.wkv6(*ts)), _np(ref.wkv6_ref(*ts)),
                               rtol=2e-4, atol=2e-4)


def test_wkv6_strong_decay_stays_finite():
    """logw = -1 per token (a decay trained models do reach): the
    reference's half-shifted factorisation overflows within a 256-token
    chunk (exp(128) * exp(...)) and its mask multiplies inf by 0, so
    wkv6_chunked is non-finite. The port's pairwise exp(cum_i - cum_j) of a
    masked, non-positive difference stays finite and matches the sequential
    oracle."""
    js, ts = _wkv6_inputs(4, 1, 512, 2, 16, logw=-1.0)
    assert not np.isfinite(np.asarray(wkv6_chunked(*js, chunk=256))).all()
    got = ops.wkv6(*ts)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), _np(ref.wkv6_ref(*ts)),
                               rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# Mamba-2 SSD: plain version vs ref.py, the Pallas kernel and ssd_chunked
# ---------------------------------------------------------------------------


def _ssd_inputs(seed, b, s, h, p, g, n, dt=None, A=None):
    """tests/test_kernels.py's distributions: x, B, C ~ 0.5 N(0, 1),
    dt = softplus(N(0, 1) - 1), A = -exp(0.3 N(0, 1)), D = 1, unless dt or
    A is given."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)) * 0.5
    if dt is None:
        dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0))
    if A is None:
        A = -np.exp(rng.standard_normal(h) * 0.3)
    Bm = rng.standard_normal((b, s, g, n)) * 0.5
    Cm = rng.standard_normal((b, s, g, n)) * 0.5
    arrays = [np.ascontiguousarray(np.broadcast_to(a, shape), np.float32)
              for a, shape in ((x, (b, s, h, p)), (dt, (b, s, h)), (A, (h,)),
                               (Bm, (b, s, g, n)), (Cm, (b, s, g, n)),
                               (np.ones(h), (h,)))]
    return arrays, [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,s,h,p,g,n", SSD_SHAPES)
def test_ssd_plain_matches_ref_pallas_and_chunked(b, s, h, p, g, n):
    js, ts = _ssd_inputs(0, b, s, h, p, g, n)
    got = ops.mamba2_ssd(*ts)
    assert got.shape == (b, s, h, p) and got.dtype == torch.float32
    tol = dict(rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(_np(got), _np(jref.ssd_ref(*js)), **tol)
    np.testing.assert_allclose(
        _np(got), _np(jops.mamba2_ssd(*js, chunk=64, interpret=True)), **tol)
    np.testing.assert_allclose(_np(got), _np(ssd_chunked(*js, chunk=32)),
                               **tol)


def test_port_ssd_ref_matches_jax_ref():
    js, ts = _ssd_inputs(5, 2, 40, 4, 16, 2, 8)
    np.testing.assert_allclose(_np(ref.ssd_ref(*ts)), _np(jref.ssd_ref(*js)),
                               rtol=1e-5, atol=1e-5)


def test_ssd_ragged_length():
    js, ts = _ssd_inputs(6, 1, 601, 2, 16, 1, 8)
    with pytest.raises((TypeError, ValueError)):
        ssd_chunked(*js, chunk=256)
    np.testing.assert_allclose(_np(ops.mamba2_ssd(*ts)), _np(ref.ssd_ref(*ts)),
                               rtol=5e-4, atol=5e-4)


def test_ssd_strong_decay_stays_finite():
    """dt = 0.1 and A = -16 (zamba2-7b's init reaches A_log = log 16):
    -1.6 per token, about -410 over a 256-token chunk, where the
    reference's half-shifted factorisation overflows and ssd_chunked is
    non-finite. The port's plain version stays finite and matches the
    sequential oracle."""
    js, ts = _ssd_inputs(7, 1, 512, 2, 16, 1, 8, dt=0.1, A=-16.0)
    assert not np.isfinite(np.asarray(ssd_chunked(*js, chunk=256))).all()
    got = ops.mamba2_ssd(*ts)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), _np(ref.ssd_ref(*ts)),
                               rtol=5e-4, atol=5e-4)


def _chunked_bf16_mirror(x, dt, A, Bm, Cm, D, chunk=64):
    """The bf16 SSD kernel's arithmetic (csrc/mamba2_ssd.cu,
    ``ssd_chunk_kernel``) in plain torch: per chunk, G = C Bᵀ of the bf16
    inputs in fp32; L = G exp(cum_t - cum_j), masked, held as a bf16 pair
    (hi = bf16(L) and lo = bf16(L - hi), the two products summed in fp32);
    xd = dt x and xw = dt exp(tot - cum_j) x rounded to bf16; y =
    exp(cum_t) (C bf16(S)) + L xd + D x in fp32, rounded once to bf16;
    S = exp(tot) S + Bᵀ xw in fp32. x, dt: (B, S, H, P), (B, S, H)."""
    def bf(t):
        return t.to(torch.bfloat16).float()

    b, s, h, p = x.shape
    reps = h // Bm.shape[2]
    xf, dtf = x.float().permute(0, 2, 1, 3), dt.float().permute(0, 2, 1)
    Bh, Ch = (m.float().repeat_interleave(reps, 2).permute(0, 2, 1, 3)
              for m in (Bm, Cm))
    state = torch.zeros(b, h, Bm.shape[3], p)
    ys = []
    for c0 in range(0, s, chunk):
        xc, dc = xf[:, :, c0:c0 + chunk], dtf[:, :, c0:c0 + chunk]
        bc, cc = Bh[:, :, c0:c0 + chunk], Ch[:, :, c0:c0 + chunk]
        cum = (dc * A.float()[None, :, None]).cumsum(-1)
        tot = cum[..., -1:]
        n = cum.shape[-1]
        lower = torch.ones(n, n, dtype=torch.bool).tril()
        diff = cum[..., :, None] - cum[..., None, :]
        dec = torch.exp(torch.where(lower, diff.clamp(max=0.0),
                                    torch.full_like(diff, -float("inf"))))
        L = (cc @ bc.transpose(-1, -2)) * dec
        L = bf(L) + bf(L - bf(L))
        xd = bf(xc * dc[..., None])
        ys.append(torch.exp(cum)[..., None] * (cc @ bf(state)) + L @ xd
                  + xc * D.float()[None, :, None, None])
        xw = bf(xc * (dc * torch.exp((tot - cum).clamp(max=0.0)))[..., None])
        state = torch.exp(tot)[..., None] * state + bc.transpose(-1, -2) @ xw
    return torch.cat(ys, 2).permute(0, 2, 1, 3).to(torch.bfloat16)


def _card_ssd_draws(seed, b, s, h, p, g, n, strong):
    """test_torch_card.py's draws in bf16: x, B, C ~ 0.5 N(0, 1) rounded to
    bf16; dt = softplus(N(0, 1) - 1) and A = -exp(0.3 N(0, 1)), or with
    ``strong`` dt in (0.1, 0.5) and A in (-16, -1), dt A down to -8."""
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)

    x = t(rng.standard_normal((b, s, h, p)) * 0.5, torch.bfloat16)
    if strong:
        dt = t(rng.uniform(0.1, 0.5, (b, s, h)))
        A = t(-rng.uniform(1.0, 16.0, h))
    else:
        dt = t(np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0)))
        A = t(-np.exp(rng.standard_normal(h) * 0.3))
    Bm = t(rng.standard_normal((b, s, g, n)) * 0.5, torch.bfloat16)
    Cm = t(rng.standard_normal((b, s, g, n)) * 0.5, torch.bfloat16)
    return x, dt, A, Bm, Cm, t(np.ones(h))


@pytest.mark.parametrize("strong", [False, True])
def test_ssd_bf16_kernel_arithmetic_holds_tolerance(strong):
    """The bf16 kernel rounds L, xd, xw and the state copy to bf16 for the
    tensor cores. Mirrored on the CPU at S = 2048, H = 2, P = N = 64, it
    stays within the bf16 tolerance (2e-2) of the fp32 plain version on the
    same bf16 inputs, at the card tests' normal and strong decays."""
    x, dt, A, Bm, Cm, D = _card_ssd_draws(12, 1, 2048, 2, 64, 1, 64, strong)
    got = _chunked_bf16_mirror(x, dt, A, Bm, Cm, D)
    tr = lambda a: a.float().permute(0, 2, 1, 3)
    want = tr(ssd.ssd_plain(tr(x), dt.permute(0, 2, 1), A, tr(Bm), tr(Cm),
                            D))
    assert bool(torch.isfinite(got.float()).all())
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


def _wkv6_chunked_bf16_mirror(r, k, v, logw, u, operand=torch.float16,
                              chunk=64, sub=16):
    """The bf16 WKV6 kernel's arithmetic (csrc/wkv6.cu, ``wkv6_chunk_kernel``)
    in plain torch, rounding to ``operand`` (fp16, as the kernel does) every
    tensor-core operand the kernel rounds, with fp32 accumulation. Per chunk,
    cum (log2 units) and its exclusive ce; per 16-token sub-chunk w (b the
    token before it, e_J the last of sub-chunk J): kt_J = k 2^(cum_e_J -
    cum); r_off = r 2^(ce - cum_b); y = (r_off 2^cum_b) S_prev +
    sum_{J<w} ((r_off 2^(cum_b - cum_e_J)) kt_J^T) v_J + A_ww v + (r u k) v,
    A_ww by levels of 8, 4, 2 and 1 tokens, each a product of r 2^(ce -
    cum_m) and k 2^(cum_m - cum) for the boundary m of the pair's block,
    masked, rounded; y rounded once to bf16; S = 2^(cum_e_J - cum_e_J-1) S
    + kt_J^T v_J for J = 0 .. 3. r, k, v, logw: (B, S, H, K)."""
    def rnd(t):
        return t.to(operand).float()

    def exp2(t):
        return torch.exp2(t.clamp(max=0.0))

    b, s, h, dk = r.shape
    tr = lambda a: a.float().permute(0, 2, 1, 3)
    rf, kf, vf = tr(r), tr(k), rnd(tr(v))
    lw = tr(logw) * 1.4426950408889634
    bonus_u = u.float()[None, :, None, :]
    state = torch.zeros(b, h, dk, dk)
    pos = torch.arange(sub)
    ys = []
    for c0 in range(0, s, chunk):
        rc, kc, vc = (a[:, :, c0:c0 + chunk] for a in (rf, kf, vf))
        cum = lw[:, :, c0:c0 + chunk].cumsum(2)
        n = cum.shape[2]
        ce = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]], 2)
        subs = [slice(j0, min(j0 + sub, n)) for j0 in range(0, n, sub)]
        ends = [cum[:, :, sl.stop - 1:sl.stop] for sl in subs]
        kt = [rnd(kc[:, :, sl] * exp2(e - cum[:, :, sl]))
              for sl, e in zip(subs, ends)]
        s_prev = rnd(state)
        for w, sl in enumerate(subs):
            m = sl.stop - sl.start
            base = ends[w - 1] if w else torch.zeros_like(cum[:, :, :1])
            r_off = rc[:, :, sl] * exp2(ce[:, :, sl] - base)
            y = rnd(r_off * exp2(base)) @ s_prev
            for J in range(w):
                d = exp2(base - ends[J]) if J < w - 1 else 1.0
                a = rnd(rnd(r_off * d) @ kt[J].transpose(-1, -2))
                y = y + a @ vc[:, :, subs[J]]
            p = pos[:m]
            for hs in (8, 4, 2, 1):
                blk = p & ~(2 * hs - 1)
                i_side = (p & hs) != 0
                cm = cum[:, :, sl][:, :, (blk + hs - 1).clamp(max=m - 1)]
                rl = rnd(torch.where(i_side[:, None],
                                     rc[:, :, sl] * exp2(ce[:, :, sl] - cm),
                                     torch.zeros(())))
                kl = rnd(kc[:, :, sl] * exp2(cm - cum[:, :, sl]))
                keep = i_side[:, None] & ~i_side[None, :] & \
                    (blk[:, None] == blk[None, :])
                a = rnd(torch.where(keep, rl @ kl.transpose(-1, -2),
                                    torch.zeros(())))
                y = y + a @ vc[:, :, sl]
            bonus = (rc[:, :, sl] * bonus_u * kc[:, :, sl]).sum(-1, keepdim=True)
            ys.append(y + bonus * vc[:, :, sl])
        prev = torch.zeros_like(cum[:, :, :1])
        for sl, e, ktj in zip(subs, ends, kt):
            state = exp2(e - prev).transpose(-1, -2) * state + \
                ktj.transpose(-1, -2) @ vc[:, :, sl]
            prev = e
    return torch.cat(ys, 2).permute(0, 2, 1, 3).to(torch.bfloat16)


def _card_wkv6_draws(seed, b, s, h, k, strong):
    """test_torch_card.py's draws: r, k, v ~ 0.5 N(0, 1) rounded to bf16;
    logw = -exp(U(-7, -0.7)), or with ``strong`` -exp(U(log 0.3, log 3)),
    logw in (-3, -0.3); u ~ 0.3 N(0, 1); logw and u fp32."""
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)

    r, kk, v = (t(rng.standard_normal((b, s, h, k)) * 0.5, torch.bfloat16)
                for _ in range(3))
    lo, hi = (np.log(0.3), np.log(3.0)) if strong else (-7.0, -0.7)
    logw = t(-np.exp(rng.uniform(lo, hi, (b, s, h, k))))
    return r, kk, v, logw, t(rng.standard_normal((h, k)) * 0.3)


def _wkv6_plain_bshk(r, k, v, logw, u):
    tr = lambda a: a.permute(0, 2, 1, 3)
    return tr(wkv.wkv6_plain(tr(r), tr(k), tr(v), tr(logw), u))


@pytest.mark.parametrize("strong", [False, True])
def test_wkv6_bf16_kernel_arithmetic_holds_tolerance(strong):
    """The bf16 kernel rounds its decayed operands (r and k times decays,
    the attention blocks, the state copy, v) to fp16 for the tensor cores.
    Mirrored on the CPU at S = 2048, H = 2, K = 64, it stays within the bf16
    tolerance (2e-2) of the fp32 plain version on the same bf16 inputs, at
    the card tests' normal and strong decays, and is finite everywhere."""
    args = _card_wkv6_draws(12, 1, 2048, 2, 64, strong)
    got = _wkv6_chunked_bf16_mirror(*args)
    assert bool(torch.isfinite(got.float()).all())
    np.testing.assert_allclose(_np(got), _np(_wkv6_plain_bshk(*args)),
                               rtol=2e-2, atol=2e-2)


def test_wkv6_bf16_operands_would_miss_tolerance():
    """Why the kernel's operands are fp16: the same arithmetic with bf16
    operands leaves the bf16 tolerance at S = 2048 (every rounding site
    adds its share, and the state's slow channels carry them for hundreds
    of tokens), while the decomposition itself is exact in fp32."""
    args = _card_wkv6_draws(12, 1, 2048, 2, 64, False)
    want = _wkv6_plain_bshk(*args)
    got = _wkv6_chunked_bf16_mirror(*args, operand=torch.bfloat16)
    assert not np.allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)
    exact = _wkv6_chunked_bf16_mirror(*args, operand=torch.float32)
    np.testing.assert_allclose(_np(exact), _np(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("s,k", [(1, 64), (63, 16), (65, 32), (601, 64)])
def test_wkv6_bf16_mirror_matches_sequential_ref(s, k):
    """The mirror's decomposition (sub-chunks, levels, a short last chunk,
    K below 64) against the sequential oracle at strong decay: with fp32
    operands within 1e-2 (its output is still rounded to bf16), and with
    the kernel's fp16 operands within the bf16 tolerance."""
    args = _card_wkv6_draws(13, 2, s, 2, k, True)
    want = ref.wkv6_ref(*args)
    got = _wkv6_chunked_bf16_mirror(*args, operand=torch.float32)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=1e-2)
    got = _wkv6_chunked_bf16_mirror(*args)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


def test_ssd_bf16_layout_checks():
    """What the bf16 SSD and WKV6 kernels' 16-byte copies accept, on CPU
    tensors (WKV6 takes the same check)."""
    assert wkv.check_layout is ssd.check_layout
    bf = torch.bfloat16
    x = torch.zeros(2, 64, 4, 64, dtype=bf)
    ssd.check_layout("x", x.permute(0, 2, 1, 3))             # the model's view
    bc = torch.zeros(2, 64, 2 * 64, dtype=bf)                 # B and C halves
    for half in (bc[..., :64], bc[..., 64:]):
        ssd.check_layout("B", half.unflatten(-1, (1, 64)).permute(0, 2, 1, 3))
    rkv = torch.zeros(2, 64, 3 * 4 * 16 + 64, dtype=bf)       # WKV6 r, k, v
    for i in range(3):
        view = rkv[..., i * 64:(i + 1) * 64].unflatten(-1, (4, 16))
        ssd.check_layout("r", view.permute(0, 2, 1, 3))
    ssd.check_layout("logw", torch.zeros(2, 64, 4, 16).permute(0, 2, 1, 3))
    ssd.check_layout("x", torch.zeros(1, 1, 1, 8, dtype=bf)
                     .as_strided((1, 1, 1, 8), (3, 5, 7, 1)))  # size-1 dims
    bad = [torch.zeros(1, 64, 2, 72, dtype=bf)[..., 1:65],     # base + 2 bytes
           torch.zeros(1, 64, 2, 68, dtype=bf)[..., :64],      # 136-byte stride
           torch.zeros(1, 64, 2, 64, dtype=bf).transpose(2, 3),  # strided P
           torch.zeros(1, 64, 2, 12, dtype=bf)]                 # 24-byte rows
    for t in bad:
        with pytest.raises(ValueError):
            ssd.check_layout("x", t.permute(0, 2, 1, 3))


# ---------------------------------------------------------------------------
# wrappers: strided views, no fallback, launch counts
# ---------------------------------------------------------------------------


def test_flash_adapter_passes_views_not_copies(monkeypatch):
    seen = {}

    def spy(q, k, v, *, causal):
        seen.update(q=q, k=k, v=v)
        return fa.flash_attention_plain(q, k, v, causal=causal)

    monkeypatch.setattr(fa, "flash_attention_bhsd", spy)
    q, k, v = (torch.randn(2, 16, h, 8) for h in (4, 2, 2))
    out = ops.flash_attention(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        assert seen[name].data_ptr() == t.data_ptr(), name
        assert seen[name].shape == (2, t.shape[2], 16, 8), name
    assert out.shape == q.shape


def test_decode_adapter_passes_cache_views_not_copies(monkeypatch):
    seen = {}

    def spy(q, k_cache, v_cache, cache_len):
        seen.update(k=k_cache, v=v_cache)
        return dec.decode_attention_plain(q, k_cache, v_cache, cache_len)

    monkeypatch.setattr(dec, "decode_attention_bhd", spy)
    kc, vc = torch.randn(2, 32, 2, 8), torch.randn(2, 32, 2, 8)
    out = ops.decode_attention(torch.randn(2, 1, 4, 8), kc, vc,
                               torch.tensor([3, 32]))
    assert seen["k"].data_ptr() == kc.data_ptr()
    assert seen["v"].data_ptr() == vc.data_ptr()
    assert seen["k"].shape == (2, 2, 32, 8)
    assert out.shape == (2, 1, 4, 8)


def test_wkv6_adapter_passes_views_not_copies(monkeypatch):
    seen = []

    def spy(r, k, v, logw, u):
        seen.extend([r, k, v, logw])
        return wkv.wkv6_plain(r, k, v, logw, u)

    monkeypatch.setattr(wkv, "wkv6_bhsk", spy)
    ins = [torch.randn(2, 16, 3, 8) for _ in range(4)]
    out = ops.wkv6(*ins, torch.randn(3, 8))
    for got, t in zip(seen, ins):
        assert got.data_ptr() == t.data_ptr() and got.shape == (2, 3, 16, 8)
    assert out.shape == (2, 16, 3, 8)


def test_ssd_adapter_passes_views_not_copies(monkeypatch):
    """In the model B and C are slices of one (B, S, 2 G N) tensor: the
    adapter hands the kernel those strided views as they are."""
    seen = {}

    def spy(x, dt, A, Bm, Cm, D):
        seen.update(x=x, dt=dt, B=Bm, C=Cm)
        return ssd.ssd_plain(x, dt, A, Bm, Cm, D)

    monkeypatch.setattr(ssd, "ssd_bhsp", spy)
    x, dt = torch.randn(2, 16, 4, 8), torch.rand(2, 16, 4)
    bc = torch.randn(2, 16, 2 * 6)
    Bm, Cm = bc[..., :6].reshape(2, 16, 1, 6), bc[..., 6:].reshape(2, 16, 1, 6)
    out = ops.mamba2_ssd(x, dt, -torch.rand(4), Bm, Cm, torch.ones(4))
    for name, t, shape in (("x", x, (2, 4, 16, 8)), ("dt", dt, (2, 4, 16)),
                           ("B", Bm, (2, 1, 16, 6)), ("C", Cm, (2, 1, 16, 6))):
        assert seen[name].data_ptr() == t.data_ptr(), name
        assert seen[name].shape == shape, name
    assert out.shape == x.shape


def test_recurrence_wrappers_cpu_take_plain_without_counting():
    before = (wkv.wkv6_bhsk.launches, ssd.ssd_bhsp.launches)
    ops.wkv6(*(torch.randn(1, 8, 2, 8) for _ in range(4)), torch.randn(2, 8))
    ops.mamba2_ssd(torch.randn(1, 8, 2, 8), torch.rand(1, 8, 2),
                   -torch.rand(2), torch.randn(1, 8, 1, 4),
                   torch.randn(1, 8, 1, 4), torch.ones(2))
    assert (wkv.wkv6_bhsk.launches, ssd.ssd_bhsp.launches) == before


def test_recurrence_wrappers_refuse_meta_and_bad_shapes():
    m = torch.empty(1, 2, 8, 8, device="meta")
    with pytest.raises(ValueError):
        wkv.wkv6_bhsk(m, m, m, m, torch.empty(2, 8, device="meta"))
    h = torch.empty(2, device="meta")
    with pytest.raises(ValueError):
        ssd.ssd_bhsp(m, torch.empty(1, 2, 8, device="meta"), h,
                     torch.empty(1, 1, 8, 4, device="meta"),
                     torch.empty(1, 1, 8, 4, device="meta"), h)
    with pytest.raises(ValueError):
        wkv.wkv6_bhsk(*(torch.randn(1, 2, 8, 8) for _ in range(4)),
                      torch.randn(3, 8))
    with pytest.raises(ValueError):
        ssd.ssd_bhsp(torch.randn(1, 3, 8, 8), torch.rand(1, 3, 8),
                     torch.rand(3), torch.randn(1, 2, 8, 4),
                     torch.randn(1, 2, 8, 4), torch.ones(3))


def test_cpu_tensors_take_plain_version_without_counting():
    before = (fa.flash_attention_bhsd.launches,
              dec.decode_attention_bhd.launches)
    ops.flash_attention(*(torch.randn(1, 8, 2, 8) for _ in range(3)))
    ops.decode_attention(torch.randn(1, 1, 2, 8), torch.randn(1, 8, 2, 8),
                         torch.randn(1, 8, 2, 8), torch.tensor([4]))
    assert (fa.flash_attention_bhsd.launches,
            dec.decode_attention_bhd.launches) == before


def test_wrappers_refuse_devices_without_a_kernel():
    q = torch.empty(1, 2, 8, 8, device="meta")
    with pytest.raises(ValueError):
        fa.flash_attention_bhsd(q, q, q)
    with pytest.raises(ValueError):
        dec.decode_attention_bhd(torch.empty(1, 2, 8, device="meta"), q, q,
                                 torch.empty(1, device="meta"))


def test_wrappers_check_shapes():
    with pytest.raises(ValueError):
        fa.flash_attention_bhsd(torch.randn(1, 3, 8, 8), torch.randn(1, 2, 8, 8),
                                torch.randn(1, 2, 8, 8))
    with pytest.raises(ValueError):
        dec.decode_attention_bhd(torch.randn(1, 2, 8), torch.randn(1, 1, 8, 4),
                                 torch.randn(1, 1, 8, 4), torch.tensor([3]))


def _refuses_grad(call, inputs, plain):
    """call(*inputs) raises naming ``plain`` once one input requires grad
    with grad mode on, and runs under torch.no_grad() or without it."""
    call(*inputs)
    with_grad = [t.clone().requires_grad_(t.is_floating_point())
                 for t in inputs]
    with pytest.raises(RuntimeError, match=plain):
        call(*with_grad)
    with torch.no_grad():
        call(*with_grad)


def test_flash_wrapper_refuses_grad():
    _refuses_grad(fa.flash_attention_bhsd,
                  [torch.randn(1, 2, 8, 8) for _ in range(3)],
                  "flash_attention_plain")


def test_decode_wrapper_refuses_grad():
    _refuses_grad(dec.decode_attention_bhd,
                  [torch.randn(1, 2, 8), torch.randn(1, 2, 8, 8),
                   torch.randn(1, 2, 8, 8), torch.tensor([4])],
                  "decode_attention_plain")


def test_wkv6_wrapper_refuses_grad():
    _refuses_grad(wkv.wkv6_bhsk,
                  [*(torch.randn(1, 2, 8, 8) for _ in range(3)),
                   -torch.rand(1, 2, 8, 8), torch.randn(2, 8)], "wkv6_plain")


def test_ssd_wrapper_refuses_grad():
    _refuses_grad(ssd.ssd_bhsp,
                  [torch.randn(1, 2, 8, 8), torch.rand(1, 2, 8),
                   -torch.rand(2), torch.randn(1, 1, 8, 4),
                   torch.randn(1, 1, 8, 4), torch.ones(2)], "ssd_plain")


@pytest.mark.parametrize("s,rows,elem", [
    (1024, 64, 2),      # olmo-1b serving: 4 slots x 16 kv heads
    (512, 128, 2),      # zamba2-7b serving: 4 slots x 32 kv heads
    (1024, 64, 4), (512, 4, 2), (300, 6, 4), (64, 2, 4), (40000, 8, 2),
    (1, 1, 2)])
def test_decode_split_size(s, rows, elem):
    """A power of two from 32 up to the V rows a CTA's registers hold (128
    in bf16, 64 in fp32), the largest that still launches two CTAs per SM
    (or 32 where none does), on an H100 SXM's 132 SMs."""
    sms = 132
    split = dec.split_size(s, rows, elem, sms)
    top = dec.V_BYTES // (dec.MAX_HEAD_DIM * elem)
    assert top == {2: 128, 4: 64}[elem]
    assert split in (32, 64, 128) and split <= top
    ctas = -(-s // split) * rows
    assert split == 32 or ctas >= 2 * sms
    assert 2 * split > top or -(-s // (2 * split)) * rows < 2 * sms
    if (s, rows, elem) in ((1024, 64, 2), (512, 128, 2)):
        assert split == 128 and ctas == 512


def test_flash_tma_layout_checks():
    """What the bf16 flash kernel's tensor maps accept, on CPU tensors."""
    bf = torch.bfloat16
    q = torch.zeros(2, 64, 4, 64, dtype=bf)
    fa.check_tma_layout("q", q.permute(0, 2, 1, 3))           # the model's view
    for t in torch.zeros(2, 64, 3, 4, 64, dtype=bf).unbind(2):  # fused q, k, v
        fa.check_tma_layout("q", t.permute(0, 2, 1, 3))
    fa.check_tma_layout("q", torch.zeros(1, 1, 1, 16, dtype=bf)
                        .as_strided((1, 1, 1, 16), (3, 5, 7, 1)))  # size-1 dims
    bad = [torch.zeros(1, 64, 2, 72, dtype=bf)[..., 1:65],      # base + 2 bytes
           torch.zeros(1, 64, 2, 68, dtype=bf)[..., :64],       # 136-byte stride
           torch.zeros(1, 64, 2, 64, dtype=bf).transpose(2, 3),  # strided head dim
           torch.zeros(1, 64, 2, 12, dtype=bf)]                  # 24-byte rows
    for t in bad:
        with pytest.raises(ValueError):
            fa.check_tma_layout("q", t.permute(0, 2, 1, 3))
    strides = fa._map_strides(torch.zeros(1, 5, 1, 36, dtype=bf)
                              .as_strided((1, 5, 1, 36), (7, 36, 9, 1)))
    assert strides == [40, 40, 36]      # size-1 dims: 36 rounded to 16 bytes


def test_decode_cache_layout_checks():
    cache = torch.zeros(2, 32, 4, 112, dtype=torch.bfloat16)
    dec.check_cache_layout("k_cache", cache.permute(0, 2, 1, 3))
    dec.check_cache_layout("k_cache", torch.zeros(2, 32, 4, 16)
                           .permute(0, 2, 1, 3))           # fp32, 64-byte rows
    bad = [torch.zeros(2, 32, 4, 120, dtype=torch.bfloat16)[..., 4:116],
           torch.zeros(2, 32, 4, 12, dtype=torch.bfloat16),
           torch.zeros(2, 32, 4, 8).transpose(2, 3)]
    for t in bad:
        with pytest.raises(ValueError):
            dec.check_cache_layout("k_cache", t.permute(0, 2, 1, 3))
