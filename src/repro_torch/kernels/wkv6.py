"""RWKV-6 WKV recurrence: the port of ``repro/kernels/rwkv6.py``.

Replaces the Pallas TPU kernel ``_wkv6_kernel`` / ``wkv6_bhsk`` with the
hand-written CUDA kernels in ``csrc/wkv6.cu`` (sm_90a), one launch per call.
bf16 takes the chunked tensor-core kernel: one CTA per (b, h, tile of 64
value columns) walks chunks of 64 tokens in order, with the two-level
chunking of gated linear attention (Yang et al., 2023) on ``mma.sync``
while the next chunk's loads are in flight; the fp32 state is the warps'
mma accumulator. Its operands are fp16 with fp32 accumulation: bf16 operands
missed the bf16 tolerance at S = 2048 in a CPU mirror of the kernel's
roundings (``tests/test_torch_kernels.py``). fp32 takes the scalar kernel:
one block per (b, h) walks the recurrence token by token, each thread
holding one column of the (K x K) fp32 state in registers.

Bound on the H100: bytes. At the rwkv6-7b prefill shape (B=4, S=2048, H=64,
K=64; bf16 r, k, v and y, fp32 logw) it must move 403 MB, about 0.120 ms at
3.35 TB/s; its 8.6e9 FLOP take about 9 us at the bf16 tensor-core rate.
Both kernels read each input once through the model's (B, S, H, K) strides
and keep the state on chip. The bf16 kernel's 16-byte copies need K a
multiple of 8 and 16-byte aligned bases and strides (``check_layout``);
other layouts raise.

The Pallas kernel (and the reference model's ``wkv6_chunked``) factor the
intra-chunk decay into two exponentials with half-shifted exponents, which
overflow fp32 once a chunk's summed log-decay passes about -176, and asserts
``S % chunk == 0``. Here no exponent is ever positive: the scalar kernel
applies one ``exp(logw_t) <= 1`` per token, the chunked kernel splits each
decay at a token between the pair (so both factors are ``2^x`` of a
non-positive difference, clamped at 0), and the plain version forms each
pairwise decay as ``exp(cum_i - cum_j)`` of a masked, non-positive
difference. All take any S >= 1.

The bf16 kernel's knob, ``value_tile``, is the value columns a CTA takes
(32 or 64: each is a template instance of the kernel, and the K columns are
zero-padded up to the tile); ``None`` keeps 64, and the autotuner
(``core/provision/autotune.py``) searches the other. A 32-column tile
recomputes a (b, h)'s decays in twice as many CTAs, each with a smaller
state. The fp32 kernel has no knob.

``wkv6_bhsk`` launches a kernel for CUDA tensors and takes the plain version
only for CPU tensors. ``wkv6_bhsk.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (_build, dtype_name, fake_launch, is_fake,
                                 refuse_grad)
from repro_torch.kernels.mamba2_ssd import check_layout

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGS = [_P] * 6 + [_I] * 4 + [_L] * 15
_SIGNATURES = {"wkv6_fwd": (_ARGS + [_I, _P], _I),
               "wkv6_chunk_fwd": (_ARGS + [_I, _I, _P], _I),
               "wkv6_chunk_info": ([_I, _P], _I)}
# the scalar kernel for fp32, the chunked tensor-core kernel for bf16
_ENTRIES = {torch.float32: "wkv6_fwd", torch.bfloat16: "wkv6_chunk_fwd"}
MAX_HEAD_DIM = 64
PLAIN_CHUNK = 64     # tokens per chunk of the plain version
VALUE_TILES = (32, 64)   # the bf16 kernel's instances; 64 unless asked
DEFAULT_VALUE_TILE = 64


def check_value_tile(value_tile, dtype) -> None:
    """Raise ValueError unless ``value_tile`` is None or one of the bf16
    kernel's tiles; the fp32 kernel has none. Both tiles fit every K the
    kernel takes (up to 64, zero-padded to the tile)."""
    if value_tile is None:
        return
    if dtype != torch.bfloat16:
        raise ValueError(f"only the bf16 WKV6 kernel has a value_tile knob "
                         f"(got value_tile={value_tile} for {dtype} inputs)")
    if value_tile not in VALUE_TILES:
        raise ValueError(f"value_tile {value_tile} is not one of "
                         f"{VALUE_TILES}")


def wkv6_plain(r, k, v, logw, u):
    """Plain PyTorch version. r, k, v, logw: (B, H, S, K); u: (H, K).

    Chunk-parallel, in fp32, in a form that cannot overflow: within a chunk
    the decay from token j to token i > j is exp(ce_i - cum_j) per channel,
    ce being the exclusive and cum the inclusive cumulative log-decay; the
    difference (a sum of logw <= 0) is masked with ``torch.where`` before the
    exp. The pairwise term is (B, H, C, C, K) for one chunk at a time. The
    last chunk may be short. Output in r's dtype. It has no knob: on CPU
    tensors the wrapper checks a ``value_tile`` it is given and ignores
    it."""
    b, h, s, dk = r.shape
    uf = u.float()[None, :, None, :]                          # (1, H, 1, K)
    state = torch.zeros((b, h, dk, dk), dtype=torch.float32, device=r.device)
    ys = []
    for c0 in range(0, s, PLAIN_CHUNK):
        rc, kc, vc, lw = (a[:, :, c0:c0 + PLAIN_CHUNK].float()
                          for a in (r, k, v, logw))           # (B, H, C, K)
        n = rc.shape[2]
        cum = lw.cumsum(2)                                    # inclusive
        ce = cum - lw                                         # exclusive
        tot = cum[:, :, -1:]                                  # (B, H, 1, K)
        y = (rc * torch.exp(ce)) @ state                      # earlier chunks
        lower = torch.ones(n, n, dtype=torch.bool, device=r.device).tril(-1)
        diff = ce[:, :, :, None, :] - cum[:, :, None, :, :]   # (B, H, i, j, K)
        dec = torch.exp(torch.where(lower[:, :, None], diff,
                                    torch.full_like(diff, float("-inf"))))
        att = (rc[:, :, :, None, :] * kc[:, :, None, :, :] * dec).sum(-1)
        bonus = (rc * uf * kc).sum(-1, keepdim=True)          # diagonal
        ys.append(y + att @ vc + bonus * vc)
        state = torch.exp(tot).transpose(-1, -2) * state + \
            (kc * torch.exp(tot - cum)).transpose(-1, -2) @ vc
    return torch.cat(ys, dim=2).to(r.dtype)


def wkv6_bhsk(r, k, v, logw, u, *, value_tile=None):
    """r, k, v, logw: (B, H, S, K); u: (H, K) -> y (B, H, S, K) in r's dtype.

    Any strides are accepted as long as the K dim is contiguous; the output
    has r's memory layout. ``value_tile`` (bf16 only): value columns a CTA,
    None for 64."""
    refuse_grad("the WKV6 kernel", "wkv6_plain", r, k, v, logw, u)
    if not (r.shape == k.shape == v.shape == logw.shape) or r.dim() != 4 \
            or tuple(u.shape) != (r.shape[1], r.shape[3]):
        raise ValueError(f"bad shapes r{tuple(r.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} logw{tuple(logw.shape)} "
                         f"u{tuple(u.shape)}")
    check_value_tile(value_tile, r.dtype)
    if is_fake(r):
        b, h, s, dk = r.shape
        return fake_launch("rwkv6", torch.empty_like(r), {
            "b": b, "s": s, "h": h, "k": dk, "dtype": dtype_name(r.dtype)})
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, logw, u)
    if r.device.type != "cuda":
        raise ValueError(f"no WKV6 kernel for device {r.device}")
    return _launch(r, k, v, logw, u, value_tile or 0)


wkv6_bhsk.launches = 0


def _launch(r, k, v, logw, u, value_tile):
    b, h, s, dk = r.shape
    if r.dtype not in _ENTRIES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"WKV6 takes float32 or bfloat16 r, k, v of one "
                        f"dtype, got {r.dtype}, {k.dtype}, {v.dtype}")
    if logw.dtype != torch.float32:
        raise TypeError(f"WKV6 takes float32 logw, got {logw.dtype}")
    if not (k.device == v.device == logw.device == u.device == r.device):
        raise ValueError("r, k, v, logw and u must be on one device")
    if dk > MAX_HEAD_DIM:
        raise ValueError(f"head dim {dk} > {MAX_HEAD_DIM}")
    y = torch.empty_like(r)          # keeps r's layout, e.g. a (B, S, H, K) view
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw), ("y", y)):
        if r.dtype == torch.bfloat16:
            check_layout(name, t)
        elif t.stride(3) != 1:
            raise ValueError(f"{name}'s K dim must be contiguous")
    uf = u.float().contiguous()      # (H, K), a few KB
    lib = _build.load("wkv6", _SIGNATURES)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    knob = [value_tile] if r.dtype == torch.bfloat16 else []
    rc = getattr(lib, _ENTRIES[r.dtype])(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        uf.data_ptr(), y.data_ptr(), b, s, h, dk,
        *(st for t in (r, k, v, logw, y)
          for st in (t.stride(0), t.stride(2), t.stride(1))),
        *knob, r.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"WKV6 kernel failed to launch: cudaError {rc}")
    wkv6_bhsk.launches += 1
    return y


def chunk_kernel_info(value_tile: int, device=None) -> dict:
    """The bf16 kernel's instance for ``value_tile`` on the card: its
    registers a thread, local (spilled) bytes a thread, dynamic shared
    memory a CTA, and CTAs a streaming multiprocessor holds at once."""
    return _build.kernel_info(_build.load("wkv6", _SIGNATURES),
                              "wkv6_chunk_info", value_tile, device)
