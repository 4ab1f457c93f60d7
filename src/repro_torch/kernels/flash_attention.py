"""Flash attention forward: the port of ``repro/kernels/flash_attention.py``.

Replaces the Pallas TPU kernel ``_flash_kernel`` / ``flash_attention_bhsd``
with the hand-written CUDA kernel in ``csrc/flash_attention.cu`` (sm_90a).

Bound on the H100: at the prefill shape (B=4, S=2048, H=16, D=128, causal,
bf16) it does 6.9e10 FLOP on 134 MB, so it is bound by operations (about
69 us at 989 TFLOP/s). For bf16 the kernel runs both products on the tensor
cores (wgmma) over tiles that TMA streams into shared memory, keeps scores
and probabilities on chip and skips key tiles above the diagonal. It reads
q, k, v and writes o in place through 4-D tensor maps over their strides, so
the model's (B, S, H, D) activations are never transposed or GQA-expanded;
TMA needs 16-byte aligned bases and strides (``check_tma_layout``). fp32
inputs take a scalar fp32 kernel.

The bf16 kernel's one knob, ``group``, is the number of (b, h) pairs whose
CTAs run together so that their K and V share the L2 cache; it changes
only the order of the CTAs, so the output is the same bits for every
value. ``None`` keeps the kernel's own rule (``default_group``); the
autotuner (``core/provision/autotune.py``) searches the others. The fp32
kernel has no knob.

``flash_attention_bhsd`` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors; a dry-run's fake tensors launch
nothing and are counted at ``KernelSpec.cost`` (``kernels.fake_launch``;
the model calls it causal, the cost's case).
``flash_attention_bhsd.launches`` counts kernel launches.
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
    "flash_attention_fwd": (
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I] + [_L] * 12
        + [_I, ctypes.c_float, _I, _I, _P], _I),
    "flash_attention_group": ([_I] * 4, _I),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
L2_GROUP_BYTES = 16 << 20    # the K and V a CTA group keeps in the 50 MB L2


def default_group(b: int, s: int, h: int, kv: int) -> int:
    """The bf16 kernel's own (b, h) pairs a CTA group (``group`` 0 in C,
    ``flash_attention_group`` in csrc/flash_attention.cu): as many pairs as
    keep their K and V, padded to 128 dims, within 16 MB of the L2,
    counting the H / KV query heads of a kv head once, at most B * H. At
    olmo-1b's and zamba2-7b's 4 x 2048 prefills that is 16."""
    kv_bytes = 4 * s * 128
    return min(b * h, max(1, L2_GROUP_BYTES // kv_bytes * (h // kv)))


def check_group(group, b: int, h: int, dtype) -> None:
    """Raise ValueError unless ``group`` is None or a (b, h) pair count the
    bf16 kernel takes, 1 to B * H; the fp32 kernel takes none."""
    if group is None:
        return
    if dtype != torch.bfloat16:
        raise ValueError(f"only the bf16 flash kernel has a group knob "
                         f"(got group={group} for {dtype} inputs)")
    if not 1 <= group <= b * h:
        raise ValueError(f"group {group} is not within 1 .. B * H = {b * h}")


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """Plain PyTorch version. q: (B, H, S, D); k, v: (B, KV, S, D); fp32
    math, scale 1/sqrt(D), output in q's dtype. Query head h reads kv head
    h // (H / KV). It has no knob: on CPU tensors the wrapper checks a
    ``group`` it is given and ignores it."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    qf = q.float().reshape(b, kv, h // kv, s, d) * d ** -0.5
    sc = qf @ k.float()[:, :, None].transpose(-1, -2)     # (B, KV, G, S, S)
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
        sc = sc.masked_fill(mask, float("-inf"))
    p = torch.softmax(sc, dim=-1)
    o = p @ v.float()[:, :, None]                          # (B, KV, G, S, D)
    return o.reshape(b, h, s, d).to(q.dtype)


def check_tma_layout(name, t):
    """Raise ValueError unless TMA can read or write the (B, H, S, D) bf16
    view t in place: a contiguous head dim, and a 16-byte aligned base and
    batch, head and sequence strides (a stride of a dim of size 1 is never
    used and may be anything)."""
    size = t.element_size()
    if t.stride(3) != 1:
        raise ValueError(f"{name}'s head dim must be contiguous")
    if t.data_ptr() % 16 or (t.shape[3] * size) % 16:
        raise ValueError(f"{name}: TMA needs a 16-byte aligned base and rows "
                         f"of a multiple of 16 bytes (head dim {t.shape[3]})")
    for dim in range(3):
        if t.shape[dim] > 1 and (t.stride(dim) * size) % 16:
            raise ValueError(f"{name}: stride {t.stride(dim)} of dim {dim} "
                             f"is not a multiple of 16 bytes, which TMA "
                             f"needs")


def _map_strides(t):
    """(batch, sequence, head) element strides for the kernel's tensor maps:
    a dim of size 1 gets the head dim rounded up to 16 bytes, which TMA
    accepts and which is never stepped over."""
    pad = -(-t.shape[3] * t.element_size() // 16) * 16 // t.element_size()
    return [t.stride(dim) if t.shape[dim] > 1 else pad for dim in (0, 2, 1)]


def flash_attention_bhsd(q, k, v, *, causal: bool = True, group=None):
    """q: (B, H, S, D); k, v: (B, KV, S, D) with H % KV == 0 -> (B, H, S, D).

    Any strides are accepted as long as the head dim is contiguous; the
    output has q's memory layout. ``group`` (bf16 only): (b, h) pairs a CTA
    group, None for ``default_group``'s rule."""
    refuse_grad("flash attention", "flash_attention_plain", q, k, v)
    b, h, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (s, d) \
            or h % k.shape[1]:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    check_group(group, b, h, q.dtype)
    if is_fake(q):
        return fake_launch("flash_attention", torch.empty_like(q), {
            "b": b, "s": s, "h": h, "kv": k.shape[1], "d": d,
            "dtype": dtype_name(q.dtype)})
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    return _launch(q, k, v, causal, group or 0)


flash_attention_bhsd.launches = 0


def _launch(q, k, v, causal, group):
    b, h, s, d = q.shape
    kv = k.shape[1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    o = torch.empty_like(q)          # keeps q's layout, e.g. a (B, S, H, D) view
    tensors = (("q", q), ("k", k), ("v", v), ("o", o))
    for name, t in tensors:
        if q.dtype == torch.bfloat16:
            check_tma_layout(name, t)
        elif t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    strides = [x for _, t in tensors for x in _map_strides(t)]
    lib = _build.load("flash_attention", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPES[q.dtype], b, s, h, kv, d, *strides,
        int(causal), d ** -0.5, group, q.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel failed to launch: "
                           f"cudaError {rc}")
    flash_attention_bhsd.launches += 1
    return o
