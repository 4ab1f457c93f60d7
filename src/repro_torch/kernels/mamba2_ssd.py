"""Mamba-2 SSD scan: the port of ``repro/kernels/mamba2_ssd.py``.

Replaces the Pallas TPU kernel ``_ssd_kernel`` / ``ssd_bhsp`` with the
hand-written CUDA kernels in ``csrc/mamba2_ssd.cu`` (sm_90a), one launch per
call. bf16 takes the chunked tensor-core kernel: one CTA per (b, h, tile of
64 state columns) walks chunks of 64 tokens in order, computing each chunk's
C Bᵀ, its masked decay, y and the state update with ``mma.sync`` while the
next chunk's loads are in flight; the fp32 state is the warps' mma
accumulator. fp32 takes the scalar kernel: one block per (b, h) walks the
recurrence token by token, each thread holding one column of the (N x P)
fp32 state in registers.

Bound on the H100: bytes. At the zamba2-7b prefill shape (B=4, S=2048,
H=112, P=64, G=1, N=64; bf16 x, B, C and y, fp32 dt) it must move about
240 MB, about 0.072 ms at 3.35 TB/s; the chunked form's 3e10 FLOP take about
30 us at the bf16 tensor-core rate. Both kernels read x and dt once and
write y once through the model's (B, S, H, P) strides and keep the state on
chip. The bf16 kernel's 16-byte copies need P and N multiples of 8 and
16-byte aligned bases and strides (``check_layout``); other layouts raise.

The Pallas kernel (and the reference model's ``ssd_chunked``) factor the
intra-chunk decay into two half-shifted exponentials that overflow fp32 once
a chunk's summed log-decay passes about -176, and assert
``S % chunk == 0``. Here no exponent is ever positive: the scalar kernel
applies one ``exp(dt_t A) <= 1`` per token, and the chunked kernel and the
plain version form each decay as ``exp(cum_t - cum_j)`` of a masked,
non-positive difference. All take any S >= 1.

The bf16 kernel's knob, ``state_tile``, is the state columns (of P) a CTA
takes (32 or 64: each is a template instance of the kernel, and P is
zero-padded up to a multiple of the tile); ``None`` keeps 64, and the
autotuner (``core/provision/autotune.py``) searches the other. A 32-column
tile recomputes each chunk's C Bᵀ in twice as many CTAs, each with less
shared memory and fewer registers. The fp32 kernel has no knob.

``ssd_bhsp`` launches a kernel for CUDA tensors and takes the plain version
only for CPU tensors. ``ssd_bhsp.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (_build, dtype_name, fake_launch, is_fake,
                                 refuse_grad)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "ssd_fwd": ([_P] * 7 + [_I] * 7 + [_L] * 15 + [_I, _I, _P], _I),
    "ssd_chunk_info": ([_I, _P], _I),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_STATE = 64
PLAIN_CHUNK = 64     # tokens per chunk of the plain version
STATE_TILES = (32, 64)   # the bf16 kernel's instances; 64 unless asked
DEFAULT_STATE_TILE = 64


def check_state_tile(state_tile, dtype) -> None:
    """Raise ValueError unless ``state_tile`` is None or one of the bf16
    kernel's tiles; the fp32 kernel has none. Both tiles fit every P the
    kernel takes (P is zero-padded to a multiple of the tile)."""
    if state_tile is None:
        return
    if dtype != torch.bfloat16:
        raise ValueError(f"only the bf16 SSD kernel has a state_tile knob "
                         f"(got state_tile={state_tile} for {dtype} inputs)")
    if state_tile not in STATE_TILES:
        raise ValueError(f"state_tile {state_tile} is not one of "
                         f"{STATE_TILES}")


def ssd_plain(x, dt, A, Bm, Cm, D):
    """Plain PyTorch version. x: (B, H, S, P); dt: (B, H, S); A, D: (H,);
    Bm, Cm: (B, G, S, N), head h reading group h // (H / G).

    Chunk-parallel, in fp32, in a form that cannot overflow: within a chunk
    the decay from token j to token t >= j is exp(cum_t - cum_j), the
    difference (a sum of dt A <= 0) masked with ``torch.where`` before the
    exp. The last chunk may be short. Output in x's dtype. It has no knob:
    on CPU tensors the wrapper checks a ``state_tile`` it is given and
    ignores it."""
    b, h, s, p_ = x.shape
    reps = h // Bm.shape[1]
    Bh = Bm.float().repeat_interleave(reps, dim=1)            # (B, H, S, N)
    Ch = Cm.float().repeat_interleave(reps, dim=1)
    la = dt.float() * A.float()[None, :, None]                # (B, H, S) <= 0
    xd = x.float() * dt.float()[..., None]                    # dt-weighted
    state = torch.zeros((b, h, Bm.shape[3], p_), dtype=torch.float32,
                        device=x.device)
    ys = []
    for c0 in range(0, s, PLAIN_CHUNK):
        bc, cc, xc = (a[:, :, c0:c0 + PLAIN_CHUNK] for a in (Bh, Ch, xd))
        cum = la[:, :, c0:c0 + PLAIN_CHUNK].cumsum(-1)        # inclusive
        n = cum.shape[-1]
        tot = cum[..., -1:]
        y = (cc * torch.exp(cum)[..., None]) @ state          # earlier chunks
        lower = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
        diff = cum[..., :, None] - cum[..., None, :]          # (B, H, t, j)
        dec = torch.exp(torch.where(lower, diff,
                                    torch.full_like(diff, float("-inf"))))
        ys.append(y + ((cc @ bc.transpose(-1, -2)) * dec) @ xc)
        state = torch.exp(tot)[..., None] * state + \
            (bc * torch.exp(tot - cum)[..., None]).transpose(-1, -2) @ xc
    y = torch.cat(ys, dim=2) + x.float() * D.float()[None, :, None, None]
    return y.to(x.dtype)


def check_layout(name, t):
    """Raise ValueError unless a bf16 chunked kernel's 16-byte copies (the
    SSD kernel's and the WKV6 kernel's) can read or write the 4-d view t in
    place, (B, H or G, S, last) with the last dim P, N or K: a contiguous
    last dim of a multiple of 16 bytes, and a 16-byte aligned base and
    batch, head and sequence strides (a stride of a dim of size 1 is never
    used and may be anything)."""
    size = t.element_size()
    if t.stride(3) != 1:
        raise ValueError(f"{name}'s last dim must be contiguous")
    if t.data_ptr() % 16 or (t.shape[3] * size) % 16:
        raise ValueError(f"{name}: the bf16 kernel needs a 16-byte aligned "
                         f"base and rows of a multiple of 16 bytes (last dim "
                         f"{t.shape[3]})")
    for dim in range(3):
        if t.shape[dim] > 1 and (t.stride(dim) * size) % 16:
            raise ValueError(f"{name}: stride {t.stride(dim)} of dim {dim} "
                             f"is not a multiple of 16 bytes, which the "
                             f"bf16 kernel needs")


def ssd_bhsp(x, dt, A, Bm, Cm, D, *, state_tile=None):
    """x: (B, H, S, P); dt: (B, H, S); A, D: (H,); Bm, Cm: (B, G, S, N) ->
    y (B, H, S, P) in x's dtype.

    Any strides are accepted as long as the P and N dims are contiguous;
    the output has x's memory layout. ``state_tile`` (bf16 only): state
    columns a CTA, None for 64."""
    refuse_grad("the SSD kernel", "ssd_plain", x, dt, A, Bm, Cm, D)
    b, h, s, p_ = x.shape
    if x.dim() != 4 or tuple(dt.shape) != (b, h, s) \
            or tuple(A.shape) != (h,) or tuple(D.shape) != (h,) \
            or Bm.shape != Cm.shape or Bm.dim() != 4 \
            or Bm.shape[0] != b or Bm.shape[2] != s or h % Bm.shape[1]:
        raise ValueError(f"bad shapes x{tuple(x.shape)} dt{tuple(dt.shape)} "
                         f"A{tuple(A.shape)} B{tuple(Bm.shape)} "
                         f"C{tuple(Cm.shape)} D{tuple(D.shape)}")
    check_state_tile(state_tile, x.dtype)
    if is_fake(x):
        return fake_launch("mamba2_ssd", torch.empty_like(x), {
            "b": b, "s": s, "h": h, "p": p_, "n": Bm.shape[3],
            "g": Bm.shape[1], "dtype": dtype_name(x.dtype)})
    if x.device.type == "cpu":
        return ssd_plain(x, dt, A, Bm, Cm, D)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD kernel for device {x.device}")
    return _launch(x, dt, A, Bm, Cm, D, state_tile or 0)


ssd_bhsp.launches = 0


def _launch(x, dt, A, Bm, Cm, D, state_tile):
    b, h, s, p_ = x.shape
    g, n = Bm.shape[1], Bm.shape[3]
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"SSD takes float32 or bfloat16 x, B, C of one dtype, "
                        f"got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32:
        raise TypeError(f"SSD takes float32 dt, got {dt.dtype}")
    if not (dt.device == A.device == Bm.device == Cm.device == D.device
            == x.device):
        raise ValueError("x, dt, A, B, C and D must be on one device")
    if p_ > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"head dim {p_} > {MAX_HEAD_DIM} or state {n} > "
                         f"{MAX_STATE}")
    y = torch.empty_like(x)          # keeps x's layout, e.g. a (B, S, H, P) view
    for name, t in (("x", x), ("B", Bm), ("C", Cm), ("y", y)):
        if x.dtype == torch.bfloat16:
            check_layout(name, t)
        elif t.stride(3) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
    Af, Df = A.float().contiguous(), D.float().contiguous()   # (H,) each
    lib = _build.load("mamba2_ssd", _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.ssd_fwd(
        x.data_ptr(), dt.data_ptr(), Af.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), Df.data_ptr(), y.data_ptr(), _DTYPES[x.dtype],
        b, s, h, g, p_, n,
        x.stride(0), x.stride(2), x.stride(1),
        dt.stride(0), dt.stride(2), dt.stride(1),
        Bm.stride(0), Bm.stride(2), Bm.stride(1),
        Cm.stride(0), Cm.stride(2), Cm.stride(1),
        y.stride(0), y.stride(2), y.stride(1),
        state_tile, x.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"SSD kernel failed to launch: cudaError {rc}")
    ssd_bhsp.launches += 1
    return y


def chunk_kernel_info(state_tile: int, device=None) -> dict:
    """The bf16 kernel's instance for ``state_tile`` on the card: its
    registers a thread, local (spilled) bytes a thread, dynamic shared
    memory a CTA, and CTAs a streaming multiprocessor holds at once."""
    return _build.kernel_info(_build.load("mamba2_ssd", _SIGNATURES),
                              "ssd_chunk_info", state_tile, device)
