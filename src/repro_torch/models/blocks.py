"""Transformer blocks (the port of ``repro/models/blocks.py``): norms, RoPE,
GQA attention (the flash and decode kernels for prefill and decode, the
reference's XLA attention in plain PyTorch for training), cross-attention
(plain PyTorch, as the reference's einsums are), the KV-cache insert, the
SwiGLU MLP and the top-k capacity MoE, on one device or on a mesh.

Plain functions over dicts of tensors. Params live in fp32 and each block
casts a weight to the activations' dtype where the reference does
(``.to(cd)``); weights cast once at load (``model.cast_params``) make that a
no-op with the same values. Training keeps fp32 params and casts per call.

On a mesh (``mesh``: a ``spmd.MeshCtx``) the blocks take this rank's shards
of the weights under ``param_specs`` and run tensor-parallel: the column
shards of ``_COL_TP`` (wq, wk, wv, w_gate, w_up) and the row shards of
``_ROW_TP`` (wo, w_down), with ``tp_copy`` before and ``tp_reduce`` after,
so the attention kernels run at this rank's H/tp query heads and KV/tp KV
heads. The MoE's expert-parallel branch holds E/tp experts a rank
(``moe_block``). Without a mesh every block is the one-device block.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.sharding import spmd as S

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, fan_in=None):
    """Normal / sqrt(fan_in) in fp32, fan_in being the second-to-last dim
    (the input dim of a weight, stacked or not) unless given; divided in
    place, so that a 3 GB head holds one buffer, not two."""
    return torch.randn(shape, generator=gen, device=gen.device).div_(
        math.sqrt(shape[-2] if fan_in is None else fan_in))


def init_norm(cfg: ArchConfig, lead=(), device="cpu"):
    if not cfg.parametric_norm:   # non-parametric sentinel, as in the reference
        return {"_np": torch.zeros((*lead, 0), device=device)}
    scale = torch.ones((*lead, cfg.d_model), device=device)
    if cfg.norm_type == "layernorm":
        return {"scale": scale,
                "bias": torch.zeros((*lead, cfg.d_model), device=device)}
    return {"scale": scale}


def init_attention(cfg: ArchConfig, gen: torch.Generator, lead=(),
                   d_src=None):
    """d_src: the K/V source's width (cross-attention reads the vision
    states); d_model by default."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    d_src = d_src or d
    p = {
        "wq": dense_init(gen, (*lead, d, cfg.n_heads * hd)),
        "wk": dense_init(gen, (*lead, d_src, cfg.n_kv_heads * hd)),
        "wv": dense_init(gen, (*lead, d_src, cfg.n_kv_heads * hd)),
        "wo": dense_init(gen, (*lead, cfg.n_heads * hd, d)),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, hd), device=gen.device)
        p["k_norm"] = torch.ones((*lead, hd), device=gen.device)
    return p


def init_mlp(cfg: ArchConfig, gen: torch.Generator, lead=(), d_ff=None):
    d_ff = d_ff or cfg.d_ff
    return {"w_gate": dense_init(gen, (*lead, cfg.d_model, d_ff)),
            "w_up": dense_init(gen, (*lead, cfg.d_model, d_ff)),
            "w_down": dense_init(gen, (*lead, d_ff, cfg.d_model))}


def init_moe(cfg: ArchConfig, gen: torch.Generator, lead=()):
    """Router and experts as the reference's ``init_moe``, whose
    ``_dense_init`` takes ``fan_in = shape[0]``: that is d for the (d, E)
    router but E for the (E, d, ff) ``w_gate`` and ``w_up``, so their scale
    is 1/sqrt(E), not 1/sqrt(d). The port copies that (ROADMAP C, quirk);
    ``w_down`` passes fan_in = ff, as the reference does."""
    m, d = cfg.moe, cfg.d_model
    p = {"router": dense_init(gen, (*lead, d, m.n_experts)),
         "w_gate": dense_init(gen, (*lead, m.n_experts, d, m.d_ff_expert),
                              fan_in=m.n_experts),
         "w_up": dense_init(gen, (*lead, m.n_experts, d, m.d_ff_expert),
                            fan_in=m.n_experts),
         "w_down": dense_init(gen, (*lead, m.n_experts, m.d_ff_expert, d),
                              fan_in=m.d_ff_expert)}
    if m.n_shared_experts:
        p["shared"] = init_mlp(cfg, gen, lead,
                               d_ff=m.n_shared_experts * m.d_ff_shared)
    return p


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def apply_norm(p, x, cfg: ArchConfig):
    dtype = x.dtype
    x = x.float()
    if cfg.norm_type == "layernorm" or not cfg.parametric_norm:
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + cfg.norm_eps)
        if cfg.parametric_norm and "scale" in p:
            y = y * p["scale"] + p["bias"]
    else:
        y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + cfg.norm_eps)
        y = y * p["scale"]
    return y.to(dtype)


def rms_head_norm(x, scale, eps=1e-6):
    """qk-norm: RMS norm over the head dim (per head)."""
    dtype = x.dtype
    x = x.float()
    y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (y * scale).to(dtype)


# ---------------------------------------------------------------------------
# RoPE (half-split, not interleaved)
# ---------------------------------------------------------------------------


def rope_table(seq_len: int, head_dim: int, theta: float, device="cpu"):
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=device) / half))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    ang = torch.outer(t, freqs)                     # (S, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (S, D/2) or (B, S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:     # (S, half) -> broadcast over batch and heads
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:                  # (B, S, half), e.g. decode positions
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    # rounded to x's dtype before the products, as the reference does
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _gqa_expand(k, n_heads):
    """(B, S, KV, D) -> (B, S, H, D), each kv head repeated H / KV times
    next to itself (kv head j serves query heads j*G .. j*G + G - 1)."""
    kv = k.shape[2]
    return k if kv == n_heads else k.repeat_interleave(n_heads // kv, dim=2)


def _dot(a, b, out_dtype):
    """a @ b with the reference's ``preferred_element_type``: for fp32
    output the operands are widened first, so bf16 products are exact and
    summed in fp32 (as XLA does); otherwise the product in the operands'
    dtype is cast to ``out_dtype``."""
    if out_dtype == torch.float32:
        return a.float() @ b.float()
    return (a @ b).to(out_dtype)


def chunked_causal_attention(q, k, v, *, chunk: int = 512,
                             logit_dtype=torch.float32):
    """Online-softmax causal attention over key chunks (O(S * chunk) live
    scores). q, k, v: (B, S, H, D), kv already GQA-expanded -> (B, S, H, D)
    in q's dtype.

    As in the reference: q is scaled in its own dtype, every (q, key-chunk)
    pair is computed and masked above the diagonal, score blocks are
    materialised at ``logit_dtype`` and the running max, sum and output
    stay fp32. The chunk is ``s // max(s // chunk, 1)`` keys, the
    reference's; where that does not divide S (the reference's reshape
    fails there) the last chunk is short.
    """
    b, s, h, d = q.shape
    size = s // max(s // chunk, 1)
    qf = q.transpose(1, 2) * d ** -0.5              # (B, H, S, D)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    q_pos = torch.arange(s, device=q.device)
    m = torch.full((b, h, s), float("-inf"), device=q.device)
    l = torch.zeros((b, h, s), device=q.device)
    o = torch.zeros((b, h, s, d), device=q.device)
    for start in range(0, s, size):
        kb, vb = kt[:, :, start:start + size], vt[:, :, start:start + size]
        sc = _dot(qf, kb.transpose(-1, -2), logit_dtype)
        k_pos = torch.arange(start, start + kb.shape[2], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        scf = torch.where(mask, sc.float(), float("-inf"))
        m_new = torch.maximum(m, scf.amax(-1))
        p = torch.exp(scf - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + _dot(p.to(vb.dtype), vb, torch.float32)
        m = m_new
    o = o / l.clamp_min(1e-37)[..., None]
    return o.transpose(1, 2).to(q.dtype)


def full_causal_attention(q, k, v):
    """O(S²)-memory causal attention, the reference's path at S <= 1024.
    q, k, v: (B, S, H, D), kv already GQA-expanded. Scores and softmax in
    fp32; the probabilities are cast to v's dtype before the second
    product, whose output has v's dtype."""
    s, d = q.shape[1], q.shape[3]
    sc = _dot(q.transpose(1, 2), k.permute(0, 2, 3, 1), torch.float32) \
        * d ** -0.5                                  # (B, H, S, S)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
    return (p.to(v.dtype) @ v.transpose(1, 2)).transpose(1, 2)


def train_attention(q, k, v, n_heads: int, attn_impl: str):
    """Train mode's causal attention, dispatched on ``attn_impl`` as the
    reference's ``attention_block`` does: "xla" takes full attention at
    S <= 1024 and the chunked one above; "xla-bf16-logits" takes chunked
    attention with bf16 score blocks above 1024. Both are plain PyTorch,
    so autograd differentiates them. The kernels have no backward, in the
    reference as here, so "pallas" and "pallas-interpret" raise."""
    if attn_impl in ("pallas", "pallas-interpret"):
        raise NotImplementedError(
            f"attn_impl={attn_impl!r} cannot train: the attention kernels "
            "have no backward (nor do the reference's Pallas kernels); use "
            "'xla' or 'xla-bf16-logits'")
    if attn_impl not in ("xla", "xla-bf16-logits"):
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    kq, vq = _gqa_expand(k, n_heads), _gqa_expand(v, n_heads)
    if q.shape[1] <= 1024:
        return full_causal_attention(q, kq, vq)
    return chunked_causal_attention(
        q, kq, vq, logit_dtype=torch.bfloat16
        if attn_impl == "xla-bf16-logits" else torch.float32)


def cross_kv(p, src, cfg: ArchConfig, mesh=None, heads=None):
    """Cross-attention's K and V from the source states src (B, Nv, d_src),
    each (B, Nv, KV, D) in src's dtype: the projections, then the k-norm
    under ``qk_norm``, as the reference's ``attention_block`` computes them
    for ``kv_src``. Prefill and training pass the vision states cast to the
    compute dtype; the decode state (``transformer.init_decode_state``)
    passes them in their own dtype, as the reference's ``cross_state`` does,
    which skips the k-norm (ROADMAP C): the port applies it there too.

    On a mesh p holds this rank's wk and wv columns: with ``heads`` (h0, n),
    the kv heads that query heads h0 .. h0 + n - 1 read (``_local_kv``);
    without, every kv head, the columns gathered (the decode state's vision
    K/V, whole on every rank)."""
    b, n, _ = src.shape
    hd, cd = cfg.resolved_head_dim, src.dtype
    k, v = src @ p["wk"].to(cd), src @ p["wv"].to(cd)
    if heads is None:
        k = S.tp_gather(k, mesh, -1, sum_grads=True).view(b, n, -1, hd)
        v = S.tp_gather(v, mesh, -1, sum_grads=True).view(b, n, -1, hd)
    else:
        k, v = _local_kv(k, v, cfg, mesh, *heads)
    if cfg.qk_norm:
        k = rms_head_norm(k, S.tp_copy(p["k_norm"], mesh).to(cd))
    return k, v


def cross_attention(q, k, v):
    """Non-causal attention of q (B, S, H, D) over k, v (B, Nv, KV, D),
    query head h reading kv head h // (H / KV) as ``_gqa_expand`` maps
    them, without expanding K and V: the G = H / KV query heads of a kv
    head are one product's rows. fp32 scores of the operands (exact
    products summed in fp32), fp32 softmax, the probabilities cast to v's
    dtype before the second product -> (B, S, H, D) in v's dtype: the
    reference's einsums on expanded K and V, value for value."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, d).permute(0, 2, 3, 1, 4).reshape(
        b, kv, g * s, d)
    sc = _dot(qg, k.permute(0, 2, 3, 1), torch.float32) * d ** -0.5
    p = torch.softmax(sc, dim=-1).to(v.dtype)        # (B, KV, G * S, Nv)
    o = p @ v.transpose(1, 2)                          # (B, KV, G * S, D)
    return o.view(b, kv, g, s, d).permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


def _local_q(p, x, cfg: ArchConfig, mesh):
    """q (B, S, n, D) of the query heads h0 .. h0 + n - 1 that this rank's
    wq columns touch, and the slice of their (B, S, n * D) output that is
    this rank's columns: (q, (h0, n), keep). Without a mesh, or where the
    rank's columns are whole heads, q is the product itself and keep every
    column. Where the columns split a head (llama4-scout's 40 heads on a
    model axis of 16: 2.5 heads a rank; the spec does not look at head
    boundaries, ``param_specs``), q's columns are gathered (the gradient
    summed: two ranks read a split head) and the rank runs the whole heads
    its columns overlap."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"].to(x.dtype)
    cols = q.shape[-1]
    if not cols % hd:
        h0 = 0 if mesh is None else mesh.tp_rank * cols // hd
        return q.view(b, s, cols // hd, hd), (h0, cols // hd), slice(None)
    c0 = mesh.tp_rank * cols
    h0, h1 = c0 // hd, -(-(c0 + cols) // hd)
    q = S.tp_gather(q, mesh, -1, sum_grads=True)[..., h0 * hd:h1 * hd]
    return q.reshape(b, s, h1 - h0, hd), (h0, h1 - h0), \
        slice(c0 - h0 * hd, c0 - h0 * hd + cols)


def _all_q(p, x, cfg: ArchConfig, mesh):
    """q (B, S, H, D) of every query head, this rank's wq columns gathered
    over the model axis, and the slice of its (B, S, H * D) output that is
    this rank's columns: (q, (0, H), keep). For decode where the KV cache
    holds a sequence shard of every kv head (its kv heads do not divide the
    model axis, so the spec shards its sequence over model): every rank of
    the sequence's group attends with every head, and keeps its columns for
    its rows of wo."""
    b, s, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    cols = q.shape[-1]
    c0 = mesh.tp_rank * cols
    q = S.tp_gather(q, mesh, -1, sum_grads=True)
    return q.view(b, s, cfg.n_heads, cfg.resolved_head_dim), \
        (0, cfg.n_heads), slice(c0, c0 + cols)


def _out_proj(o, p, keep, mesh):
    """o (B, S, n, D) -> this rank's columns of it @ its wo rows, summed
    over the model axis."""
    b, s = o.shape[:2]
    out = o.reshape(b, s, -1)[..., keep] @ p["wo"].to(o.dtype)
    return S.tp_reduce(out, mesh)


def cross_attention_block(p, x, cfg: ArchConfig, *, kv_src=None, kv=None,
                          mesh=None):
    """Cross-attention sub-block on x (B, S, d): q proj -> (q-norm) ->
    ``cross_attention`` (no RoPE, no mask) -> out proj. K and V come from
    ``kv_src`` (B, Nv, d_src) through ``cross_kv`` (prefill and training),
    or are the decode state's vision K/V ``kv`` (B, Nv, KV, D) each, cast
    to x's dtype, as the reference's decode step casts its stored vision
    K/V. On a mesh this rank's query heads (``_local_q``) read their kv
    heads: of its own wk and wv columns from ``kv_src``, of the state's
    whole heads from ``kv``; its wo rows' output is summed over the model
    axis."""
    cd = x.dtype
    x = S.tp_copy(x, mesh)
    q, heads, keep = _local_q(p, x, cfg, mesh)
    if kv is None:
        k, v = cross_kv(p, kv_src, cfg, mesh, heads)
    else:
        k, v = _kv_for_heads(*kv, cfg, *heads) if mesh is not None else kv
    if cfg.qk_norm:
        q = rms_head_norm(q, S.tp_copy(p["q_norm"], mesh).to(cd))
    return _out_proj(cross_attention(q, k.to(cd), v.to(cd)), p, keep, mesh)


def _kv_for_heads(k, v, cfg: ArchConfig, h0: int, n: int):
    """K and V (B, S, KV, D) of every kv head -> those that query heads
    h0 .. h0 + n - 1 read, in the kernels' mapping (local head j reads
    local kv head j // (n / KV_loc)), which needs the heads' kv heads to
    come in equal runs."""
    g = cfg.n_heads // cfg.n_kv_heads
    lo, hi = h0 // g, (h0 + n - 1) // g + 1
    if n % (hi - lo) or any((h0 + j) // g - lo != j // (n // (hi - lo))
                            for j in range(n)):
        raise NotImplementedError(
            f"{cfg.name}: query heads {h0}..{h0 + n - 1} of {cfg.n_heads} "
            f"on {cfg.n_kv_heads} kv heads read unequal runs of kv heads")
    return k[:, :, lo:hi], v[:, :, lo:hi]


def _local_kv(k, v, cfg: ArchConfig, mesh, h0: int, n: int):
    """This rank's K and V columns (B, S, cols) -> (B, S, KV_loc, D), the
    kv heads that query heads h0 .. h0 + n - 1 read, in the kernels'
    mapping. Where the model axis does not divide the KV heads (reduced
    qwen3-8b has one), the spec still splits the columns: they are
    gathered to whole heads (the gradient summed over ranks, which read
    them with different heads) and this rank keeps the heads its query
    heads read (``_kv_for_heads``)."""
    b, s, _ = k.shape
    hd = cfg.resolved_head_dim
    if mesh is None or mesh.tp == 1 or cfg.n_kv_heads % mesh.tp == 0:
        return k.view(b, s, -1, hd), v.view(b, s, -1, hd)
    k = S.tp_gather(k, mesh, -1, sum_grads=True).view(b, s, -1, hd)
    v = S.tp_gather(v, mesh, -1, sum_grads=True).view(b, s, -1, hd)
    return _kv_for_heads(k, v, cfg, h0, n)


def attention_block(p, x, cfg: ArchConfig, *, rope=None, positions=None,
                    kv_cache=None, cache_len=None, attn_impl=None,
                    kv_src=None, mesh=None):
    """proj -> (qk-norm) -> rope -> attention -> out proj.

    attn_impl: None for prefill and decode, which run the kernels; train
    mode passes its ``ctx["attn_impl"]`` and takes ``train_attention``,
    which never reaches a kernel (a kernel's output has no ``grad_fn``).
    kv_cache: None for prefill, where attention is the flash kernel (its
    plain version on the CPU); (k, v) of shape (B, Skv, KV, D) for decode,
    where the new token's k, v are written into the cache in place and
    attention is the decode kernel over ``cache_len + 1`` positions.
    K and V are never GQA-expanded for the kernels: they map head h to kv
    head h // (H / KV). kv_src: source states (B, Nv, d_src) for
    cross-attention, the reference's ``kv_src`` branch
    (``cross_attention_block``: no RoPE and no mask, plain PyTorch in every
    mode, as the reference's einsums are). mesh: this rank's column shards
    of wq, wk and wv (its heads: ``_local_q``, ``_local_kv``), its row
    shard of wo, the partial outputs summed over the model axis; the
    qk-norm scales see this rank's heads, so their gradients are summed
    too. A decode cache whose sequence shards over the mesh
    (``mesh.kv_seq_axes``) holds this rank's positions: the new token is
    written on the rank that holds its position, the decode kernel runs
    over the rank's shard and gives a partial softmax, and the ranks of the
    sequence's group merge theirs (``spmd.merge_partials``); where "model"
    shards the sequence the cache holds every kv head, so every rank
    attends with every query head (``_all_q``). Returns (out, cache).
    """
    if kv_src is not None:
        return cross_attention_block(p, x, cfg, kv_src=kv_src,
                                     mesh=mesh), None
    cd = x.dtype
    x = S.tp_copy(x, mesh)
    seq = mesh.kv_seq_axes if kv_cache is not None and mesh is not None \
        else ()
    q, heads, keep = (_all_q if "model" in seq else _local_q)(p, x, cfg,
                                                               mesh)
    k, v = _local_kv(x @ p["wk"].to(cd), x @ p["wv"].to(cd), cfg, mesh,
                     *heads)
    if cfg.qk_norm:
        q = rms_head_norm(q, S.tp_copy(p["q_norm"], mesh).to(cd))
        k = rms_head_norm(k, S.tp_copy(p["k_norm"], mesh).to(cd))
    if rope is not None:
        cos, sin = rope
        if positions is not None:        # decode: per-token positions
            cos, sin = cos[positions], sin[positions]   # (B, 1, half)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if kv_cache is not None and seq:     # decode, the sequence sharded
        kc, vc = kv_cache
        n = kc.shape[1]
        at = cache_len - mesh.kv_shard * n   # this shard's position of it
        cache_insert(kc, k, at, mode="shard")
        cache_insert(vc, v, at, mode="shard")
        o, lse = ops.decode_attention(q, kc.to(cd), vc.to(cd),
                                      (at + 1).clamp(0, n), return_lse=True)
        o = S.merge_partials(o[:, 0], lse, mesh.kv_seq_group, cd)[:, None]
    elif kv_cache is not None:           # decode step
        kc, vc = kv_cache
        cache_insert(kc, k, cache_len)
        cache_insert(vc, v, cache_len)
        o = ops.decode_attention(q, kc.to(cd), vc.to(cd), cache_len + 1)
    elif attn_impl is not None:          # train, causal
        o = train_attention(q, k, v, q.shape[2], attn_impl)
    else:                                # prefill, causal
        o = ops.flash_attention(q, k, v, causal=True)
    return _out_proj(o, p, keep, mesh), kv_cache


def cache_insert(cache, new, idx, *, mode: str = "scatter"):
    """Write new (B, 1, KV, D) at per-batch position idx into cache
    (B, S, KV, D), in place (the reference returns a new array; updating in
    place saves a copy of the cache per layer and tick). Returns cache.

    "scatter" writes only the B rows; the caller guarantees idx < S
    (``model.make_ctx`` checks it), since an index past the end raises on
    the CPU and faults the device. "shard" is the write into one shard of
    a sequence-sharded cache, where idx (the position less the shard's
    offset) may fall outside the shard: a row whose idx is outside keeps
    its values (its position is another rank's), written back at an index
    clamped into the shard, so that no index leaves it and no host sync
    decides. "onehot" rewrites every row with the reference's one-hot
    blend, which drops idx >= S as the reference does.
    """
    if mode == "scatter":
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, idx.long()] = new[:, 0].to(cache.dtype)
    elif mode == "shard":
        rows = torch.arange(cache.shape[0], device=cache.device)
        inside = (idx >= 0) & (idx < cache.shape[1])
        at = idx.clamp(0, cache.shape[1] - 1).long()
        cache[rows, at] = torch.where(inside[:, None, None],
                                      new[:, 0].to(cache.dtype),
                                      cache[rows, at])
    elif mode == "onehot":
        pos = torch.arange(cache.shape[1], device=cache.device)
        onehot = (pos[None, :] == idx[:, None]).to(cache.dtype)
        onehot = onehot[:, :, None, None]
        cache.mul_(1 - onehot).add_(onehot * new.to(cache.dtype))
    else:
        raise ValueError(f"unknown cache insert mode {mode!r}")
    return cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_block(p, x, mesh=None):
    """SwiGLU; on a mesh this rank's d_ff columns, summed over the model
    axis."""
    cd = x.dtype
    x = S.tp_copy(x, mesh)
    g = F.silu(x @ p["w_gate"].to(cd))
    u = x @ p["w_up"].to(cd)
    return S.tp_reduce((g * u) @ p["w_down"].to(cd), mesh)


# ---------------------------------------------------------------------------
# MoE (top-k routing with capacity, the reference's dispatch on one device)
# ---------------------------------------------------------------------------


def top_k_lower_first(x, k: int):
    """The k largest entries of each row and their indices, largest first;
    among equal entries the lower index comes first, as in
    ``jax.lax.top_k`` (``torch.topk`` promises no order for ties on CUDA).
    A stable descending sort keeps equal entries in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(cfg: ArchConfig, tokens: int) -> int:
    """Slots per expert for a call of ``tokens`` tokens (all of B * S), the
    reference's expression in its order of operations."""
    m = cfg.moe
    return max(int(m.capacity_factor * m.top_k * tokens / m.n_experts), 4)


class _GatherRows(torch.autograd.Function):
    """``cat([src, zeros(1, D)])[index]``: rows of src, and zeros where the
    index is ``len(src)``, with a backward that gathers too. ``inverse`` maps
    each source row's ``fan`` uses to their output rows in order (an unused
    one to ``len(index)``), so the gradient of source row r is the sum of
    ``fan`` gathered gradient rows. Autograd's own backward of a gather
    accumulates into the source rows, and the rows that many outputs share
    (the zero row read by every empty slot and every dropped choice) then
    serialise it: 39 ms a layer on an H100 at T = 8192, k = 8."""

    @staticmethod
    def forward(ctx, src, index, inverse, fan: int):
        ctx.save_for_backward(inverse)
        ctx.fan = fan
        return torch.cat([src, src.new_zeros(1, src.shape[1])])[index]

    @staticmethod
    def backward(ctx, grad):
        (inverse,) = ctx.saved_tensors
        g = torch.cat([grad, grad.new_zeros(1, grad.shape[1])])[inverse]
        return g.view(-1, ctx.fan, g.shape[1]).sum(1), None, None, None


def _moe_local(p, x, cfg: ArchConfig, *, e0: int = 0, n_local=None,
               ep=None, shared=None):
    """The reference's ``_moe_local``: routing over all E experts, then the
    ``n_local`` experts from ``e0`` on (all E on one device). Returns
    (y (B, S, D), aux).

    Every shape follows from x's shape and the config alone, and no value
    is read back to the host, so the block is capturable in a CUDA graph.
    Each (token, choice) names its slot ``(expert - e0) * C + position``
    (kept, and routed to a local expert) or the dump slot
    ``n_local * C``; each slot names the choice that filled it, or none.
    Dispatch gathers each slot's token row (an empty slot reads zeros, as
    the reference's zeroed ``mode="drop"`` buffer gives), and combine
    gathers each choice's expert output (a dropped or remote choice reads
    zeros, the reference's ``mode="fill"``), both through ``_GatherRows``,
    whose backward gathers through the other map.

    ep: the expert-parallel branch's ``MeshCtx`` (this rank holds experts
    ``e0 .. e0 + n_local``). Routing is replicated over the model axis;
    the gates and the dispatched rows go through ``tp_copy``, since each
    rank's experts take only their choices, and the partial outputs (with
    the fused shared expert's ``shared`` d_ff slice) are summed over the
    model axis: the one collective. The aux loss reads the routing itself,
    which every rank holds whole.
    """
    m = cfg.moe
    b, s, d = x.shape
    t, k, e = b * s, m.top_k, m.n_experts
    n_local = e if n_local is None else n_local
    cd = x.dtype
    xt = x.reshape(t, d)
    logits = (xt @ p["router"].to(cd)).float()               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k_lower_first(S.tp_copy(probs, ep), k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    capacity = moe_capacity(cfg, t)
    slots = n_local * capacity

    # each (token, choice)'s place in its expert's queue, token-major and
    # choice-minor: the reference's cumsum over the (T * k, E) one-hot. A
    # stable sort by expert keeps that order within each expert, so a
    # choice's place is its rank in the sort less its expert's first rank
    # (a cumsum down the one-hot's T * k rows took 24 ms a layer on an
    # H100 at T = 8192, k = 8)
    gid = gate_idx.reshape(t * k)
    sorted_gid, order = torch.sort(gid, stable=True)
    counts = torch.zeros(e, dtype=torch.long, device=x.device).scatter_add_(
        0, gid, torch.ones_like(gid))                         # choices an expert
    rank = torch.arange(t * k, device=x.device)
    pos = torch.empty_like(gid).scatter_(
        0, order, rank - (counts.cumsum(0) - counts)[sorted_gid])
    keep = (pos < capacity) & (gid >= e0) & (gid < e0 + n_local)
    dest = torch.where(keep, (gid - e0) * capacity + pos, slots)

    slot_choice = torch.full((slots + 1,), t * k, device=x.device,
                             dtype=torch.long).scatter_(0, dest, rank)[:slots]
    slot_tok = torch.where(slot_choice < t * k, slot_choice // k, t)
    xd = S.tp_copy(xt, ep)
    buf = _GatherRows.apply(xd, slot_tok, dest, k).view(n_local, capacity, d)

    h = F.silu(torch.bmm(buf, p["w_gate"].to(cd))) \
        * torch.bmm(buf, p["w_up"].to(cd))
    ye = torch.bmm(h, p["w_down"].to(cd))                     # (E_loc, C, D)

    yg = _GatherRows.apply(ye.reshape(slots, d), dest, slot_choice, 1)
    w = (gate_vals.reshape(t * k) * keep).to(cd)
    y = (yg * w[:, None]).reshape(t, k, d).sum(1)
    if shared is not None:       # the fused shared expert's d_ff slice
        hs = F.silu(xd @ shared["w_gate"].to(cd)) \
            * (xd @ shared["w_up"].to(cd))
        y = y + hs @ shared["w_down"].to(cd)
    y = S.tp_reduce(y, ep)                                    # EP combine

    # load-balancing aux loss (Switch style); dropped choices count in ce,
    # the reference's one-hot summed over the choices, averaged over the
    # tokens, times k
    me = probs.mean(0)
    ce = counts.float() / t * k
    aux = m.router_aux_coef * e * torch.sum(me * ce)
    return y.reshape(b, s, d), aux


def moe_block(p, x, cfg: ArchConfig, *, capacity=None, mesh=None):
    """Top-k capacity MoE. Returns (y, aux).

    Without a mesh, the reference's no-mesh branch: the routed experts,
    plus the shared expert (``mlp_block`` on ``p["shared"]``) where the
    config has one. ``capacity`` is accepted and never read, as in the
    reference (ROADMAP C, quirk): capacity is ``moe_capacity`` over the
    call's tokens.

    On a mesh, the reference's condition: a model axis wider than 1 that
    divides the experts, and batch axes that divide the global batch, take
    the expert-parallel branch (``_moe_local`` at E/tp experts a rank, on
    this rank's batch shard, "pod" x "data": capacity per batch shard, and
    the aux loss the mean of the shards' losses, as the reference's
    ``pmean``; ROADMAP C). The shared expert rides the EP sum under
    ``fuse_shared``, else it is a tensor-parallel ``mlp_block``. Otherwise
    the no-mesh branch runs on the whole batch: the rows gathered over the
    batch shards, the experts over model.
    Runs under the ``moe_block`` record_function, so a profile can tell the
    block's kernels apart."""
    m = cfg.moe
    with record_function("moe_block"):
        if mesh is None:
            y, aux = _moe_local(p, x, cfg)
        elif mesh.tp > 1 and m.n_experts % mesh.tp == 0 and (
                x.shape[0] * (mesh.batches if mesh.shards_batch else 1)) \
                % mesh.batches == 0:
            n_local = m.n_experts // mesh.tp
            fuse = bool(m.n_shared_experts and m.fuse_shared)
            y, aux = _moe_local(p, x, cfg, e0=mesh.tp_rank * n_local,
                                n_local=n_local, ep=mesh,
                                shared=p["shared"] if fuse else None)
            if mesh.shards_batch:     # the pmean over the batch shards
                mean = S.all_reduce(aux, mesh.batch_group) / mesh.batches
                aux = aux + (mean - aux).detach()
            if m.n_shared_experts and not fuse:
                y = y + mlp_block(p["shared"], x, mesh)
            return y, aux
        else:
            experts = {n: S.tp_gather(p[n], mesh, 0)
                       for n in ("w_gate", "w_up", "w_down")}
            y, aux = _moe_local({**p, **experts}, S.dp_gather(x, mesh), cfg)
            y = S.dp_rows(y, mesh)
        if m.n_shared_experts:
            y = y + mlp_block(p["shared"], x, mesh)
    return y, aux
