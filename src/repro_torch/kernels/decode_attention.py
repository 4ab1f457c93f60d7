"""Decode attention (one query token against a KV cache): the port of
``repro/kernels/decode_attention.py``.

Replaces the Pallas TPU kernel ``_decode_kernel`` / ``decode_attention_bhd``
with the hand-written split-KV CUDA kernel in ``csrc/decode_attention.cu``
(sm_90a), one launch per call: CTAs over (sequence split, batch row, kv
head) in parallel, and the last CTA of each row and kv head merges the
splits' log-sum-exps.

Bound on the H100: bytes. Each valid cache position is read once per kv
head; for B=4, 1024 valid positions, KV=16, D=128 in bf16 that is 33.5 MB,
about 10 us at 3.35 TB/s. The kernel reads only positions below
``cache_len[b]`` and reads the model's (B, S, KV, D) cache in place through
its strides, with no transposed copy, in 16-byte copies (so the caches'
base and strides must be 16-byte aligned).

Its knob, ``split`` (cache positions a CTA), is shared by the bf16 and
fp32 kernels; ``None`` keeps ``split_size``'s rule, and the autotuner
(``core/provision/autotune.py``) searches the others.

``decode_attention_bhd`` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors; a dry-run's fake tensors launch
nothing and are counted at ``KernelSpec.cost`` over every position of the
buffer (a fake ``cache_len`` holds no value; ``kernels.fake_launch``).
``decode_attention_bhd.launches`` counts kernel launches (one per call).

With ``return_lse`` both return a partial softmax, for a rank that holds one
shard of a sequence-sharded cache: o in fp32 (not rounded to the input
dtype) and each row's log-sum-exp of its scaled scores over its valid
positions, ``-inf`` for a row with none (whose o is zeros); the ranks merge
their pieces with ``sharding/spmd.merge_partials``.
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
    "decode_attention_fwd": (
        [_P] * 9 + [_I] * 7 + [_L] * 10 + [ctypes.c_float, _I, _P], _I),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_GROUP = 32                  # query heads per kv head
V_BYTES = 32 * 1024             # V a CTA holds in registers at head dim 128
SMEM_CAP = 96 * 1024            # dynamic shared memory a CTA may ask
KGROUPS = 8                     # keys in flight per pass of the score loop
_tickets: dict = {}   # (device, stream) -> int32 zeros the kernel leaves zero


def split_size(s: int, rows: int, elem_size: int, sms: int) -> int:
    """Cache positions per CTA for a buffer of ``s`` positions and ``rows``
    = B * KV (batch row, kv head) pairs on a card of ``sms`` streaming
    multiprocessors: the largest power of two from ``V_BYTES / (128 *
    elem_size)`` (128 in bf16, 64 in fp32: the V rows a CTA's registers
    hold) down to 32 whose split count still launches at least two CTAs per
    SM. At the serving shapes on an H100 SXM (132 SMs), 4 x 16 rows of a
    1024 buffer and 4 x 32 rows of a 512 buffer, that is 128 positions and
    512 CTAs."""
    split = V_BYTES // (MAX_HEAD_DIM * elem_size)
    while split > 32 and -(-s // split) * rows < 2 * sms:
        split //= 2
    return split


def max_split(elem_size: int) -> int:
    """The most positions a CTA takes: the V rows its registers hold at
    head dim 128, 128 in bf16 and 64 in fp32 (``max_split`` in
    csrc/decode_attention.cu's ``launch``)."""
    return V_BYTES // (MAX_HEAD_DIM * elem_size)


def smem_bytes(split: int, d: int, group: int, elem_size: int) -> int:
    """A CTA's dynamic shared memory (``smem_bytes`` in
    csrc/decode_attention.cu): its K rows, q, the scores and the P V
    partials."""
    return split * d * elem_size + 4 * (group * MAX_HEAD_DIM + group * split
                                        + KGROUPS * MAX_HEAD_DIM)


def check_split(split, d: int, group: int, elem_size: int) -> None:
    """Raise ValueError unless ``split`` is None or a split the kernel
    takes for head dim ``d``, ``group`` query heads a kv head and elements
    of ``elem_size`` bytes: 1 to ``max_split`` positions, within
    ``SMEM_CAP`` of shared memory."""
    if split is None:
        return
    if not 1 <= split <= max_split(elem_size):
        raise ValueError(f"split {split} is not within 1 .. "
                         f"{max_split(elem_size)} positions a CTA")
    if smem_bytes(split, d, group, elem_size) > SMEM_CAP:
        raise ValueError(f"split {split} needs "
                         f"{smem_bytes(split, d, group, elem_size)} B of "
                         f"shared memory, more than {SMEM_CAP}")


def check_cache_layout(name, t):
    """Raise ValueError unless the kernel's 16-byte copies can read the
    (B, KV, S, D) cache view t in place: a contiguous head dim of a multiple
    of 16 bytes, and a 16-byte aligned base and batch, head and position
    strides."""
    size = t.element_size()
    if t.stride(3) != 1:
        raise ValueError(f"{name}'s head dim must be contiguous")
    if t.data_ptr() % 16 or (t.shape[3] * size) % 16 or any(
            t.shape[dim] > 1 and (t.stride(dim) * size) % 16
            for dim in range(3)):
        raise ValueError(f"{name}: the kernel copies 16-byte pieces, so the "
                         f"base, the strides {t.stride()} and the head dim "
                         f"{t.shape[3]} must come to multiples of 16 bytes")


def decode_attention_plain(q, k_cache, v_cache, cache_len, *,
                           return_lse: bool = False):
    """Plain PyTorch version. q: (B, H, D); caches (B, KV, S, D); cache_len
    (B,). fp32 math, scale 1/sqrt(D); positions >= cache_len[b] are masked,
    and a row with no valid position gives zeros (the Pallas kernel's finite
    mask averages all of V there; the model never asks for such a row). It
    has no knob: on CPU tensors the wrapper checks a ``split`` it is given
    and ignores it. ``return_lse``: (o fp32 (B, H, D), lse fp32 (B, H)),
    lse = m + log(l) of the scaled scores, -inf for a row with no valid
    position."""
    b, h, d = q.shape
    kv, s = k_cache.shape[1], k_cache.shape[2]
    qf = q.float().reshape(b, kv, h // kv, 1, d) * d ** -0.5
    sc = (qf @ k_cache.float()[:, :, None].transpose(-1, -2))[..., 0, :]
    valid = torch.arange(s, device=q.device)[None, :] < \
        cache_len.to(q.device)[:, None]                      # (B, S)
    sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = sc.amax(-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    e = torch.exp(sc - m)                                    # (B, KV, G, S)
    o = (e[..., None, :] @ v_cache.float()[:, :, None])[..., 0, :]
    l = e.sum(-1, keepdim=True)
    o = (o / l.clamp_min(1e-37)).reshape(b, h, d)
    if return_lse:
        return o, (m + torch.log(l)).reshape(b, h)
    return o.to(q.dtype)


def decode_attention_bhd(q, k_cache, v_cache, cache_len, *, split=None,
                         return_lse: bool = False):
    """q: (B, H, D); caches (B, KV, S, D); cache_len (B,) -> (B, H, D), or
    with ``return_lse`` (o fp32 (B, H, D), lse fp32 (B, H)).

    Any strides are accepted as long as the head dim is contiguous; on the
    card the caches' base and strides must also be 16-byte aligned
    (``check_cache_layout``). ``split``: cache positions a CTA, None for
    ``split_size``'s rule."""
    refuse_grad("decode attention", "decode_attention_plain", q, k_cache,
                v_cache)
    b, h, d = q.shape
    if k_cache.shape != v_cache.shape or k_cache.shape[0] != b \
            or k_cache.shape[3] != d or h % k_cache.shape[1] \
            or tuple(cache_len.shape) != (b,):
        raise ValueError(f"bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k_cache.shape)} v{tuple(v_cache.shape)} "
                         f"cache_len{tuple(cache_len.shape)}")
    check_split(split, d, h // k_cache.shape[1], q.element_size())
    if is_fake(q):
        kv, s = k_cache.shape[1], k_cache.shape[2]
        out = (torch.empty_like(q, dtype=torch.float32),
               q.new_empty((b, h), dtype=torch.float32)) if return_lse \
            else torch.empty_like(q)
        return fake_launch("decode_attention", out, {
            "b": b, "s": s, "h": h, "kv": kv, "d": d,
            "dtype": dtype_name(q.dtype)}, valid=b * s)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"no decode attention for device {q.device}")
    return _launch(q, k_cache, v_cache, cache_len, split, return_lse)


decode_attention_bhd.launches = 0


def _launch(q, k_cache, v_cache, cache_len, split, return_lse):
    b, h, d = q.shape
    kv, s = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"decode attention takes float32 or bfloat16 q and "
                        f"caches of one dtype, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if not (k_cache.device == v_cache.device == cache_len.device == q.device):
        raise ValueError("q, caches and cache_len must be on one device")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    if h // kv > MAX_GROUP:
        raise ValueError(f"{h // kv} query heads per kv head > {MAX_GROUP}")
    lens = cache_len.to(torch.int32).contiguous()
    o = torch.empty_like(q, dtype=torch.float32 if return_lse else q.dtype)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device) \
        if return_lse else None
    for name, t in (("q", q), ("o", o)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    check_cache_layout("k_cache", k_cache)
    check_cache_layout("v_cache", v_cache)
    if split is None:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        split = split_size(s, b * kv, q.element_size(), sms)
    nsplit = -(-s // split)
    part_acc = torch.empty(b * h * nsplit * d, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(b * h * nsplit * 2, dtype=torch.float32,
                          device=q.device)
    lib = _build.load("decode_attention", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        o.data_ptr(), None if lse is None else lse.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(),
        _ticket_buffer(q.device, stream, b * kv).data_ptr(),
        _DTYPES[q.dtype], b, s, h, kv, d, split,
        q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(2), k_cache.stride(1),
        v_cache.stride(0), v_cache.stride(2), v_cache.stride(1),
        o.stride(0), o.stride(1),
        d ** -0.5, q.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"decode attention kernel failed to launch: "
                           f"cudaError {rc}")
    decode_attention_bhd.launches += 1
    return o if lse is None else (o, lse)


def _ticket_buffer(device, stream: int, n: int):
    """The int32 tickets of one (device, stream), one per (batch row, kv
    head), zeroed once on that stream (one fill kernel when the buffer
    first grows) and left zero by every launch, so a call enqueues no
    kernel but the decode kernel. Launches on one stream run in order, so
    each counts on its own zeroed tickets; launches on two streams never
    share a buffer, and may run at once."""
    key = (device, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf
