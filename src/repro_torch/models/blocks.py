"""Transformer blocks (the port of ``repro/models/blocks.py``): norms, RoPE,
GQA attention over the flash and decode kernels, the KV-cache insert and the
SwiGLU MLP.

Plain functions over dicts of tensors. Params live in fp32 and each block
casts a weight to the activations' dtype where the reference does
(``.to(cd)``); weights cast once at load (``model.cast_params``) make that a
no-op with the same values. MoE, cross-attention and the chunked XLA
attention are not ported yet.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, fan_in=None):
    """Normal / sqrt(fan_in) in fp32, fan_in being the second-to-last dim
    (the input dim of a weight, stacked or not) unless given."""
    return torch.randn(shape, generator=gen, device=gen.device) \
        / math.sqrt(shape[-2] if fan_in is None else fan_in)


def init_norm(cfg: ArchConfig, lead=(), device="cpu"):
    if not cfg.parametric_norm:   # non-parametric sentinel, as in the reference
        return {"_np": torch.zeros((*lead, 0), device=device)}
    scale = torch.ones((*lead, cfg.d_model), device=device)
    if cfg.norm_type == "layernorm":
        return {"scale": scale,
                "bias": torch.zeros((*lead, cfg.d_model), device=device)}
    return {"scale": scale}


def init_attention(cfg: ArchConfig, gen: torch.Generator, lead=()):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, (*lead, d, cfg.n_heads * hd)),
        "wk": dense_init(gen, (*lead, d, cfg.n_kv_heads * hd)),
        "wv": dense_init(gen, (*lead, d, cfg.n_kv_heads * hd)),
        "wo": dense_init(gen, (*lead, cfg.n_heads * hd, d)),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, hd), device=gen.device)
        p["k_norm"] = torch.ones((*lead, hd), device=gen.device)
    return p


def init_mlp(cfg: ArchConfig, gen: torch.Generator, lead=()):
    return {"w_gate": dense_init(gen, (*lead, cfg.d_model, cfg.d_ff)),
            "w_up": dense_init(gen, (*lead, cfg.d_model, cfg.d_ff)),
            "w_down": dense_init(gen, (*lead, cfg.d_ff, cfg.d_model))}


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


def attention_block(p, x, cfg: ArchConfig, *, rope=None, positions=None,
                    kv_cache=None, cache_len=None):
    """proj -> (qk-norm) -> rope -> attention -> out proj.

    kv_cache: None for prefill, where attention is the flash kernel (its
    plain version on the CPU); (k, v) of shape (B, Skv, KV, D) for decode,
    where the new token's k, v are written into the cache in place and
    attention is the decode kernel over ``cache_len + 1`` positions.
    K and V are never GQA-expanded: the kernels map head h to kv head
    h // (H / KV). Returns (out, cache).
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    cd = x.dtype
    q = (x @ p["wq"].to(cd)).view(b, s, cfg.n_heads, hd)
    k = (x @ p["wk"].to(cd)).view(b, s, cfg.n_kv_heads, hd)
    v = (x @ p["wv"].to(cd)).view(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"].to(cd))
        k = rms_head_norm(k, p["k_norm"].to(cd))
    if rope is not None:
        cos, sin = rope
        if positions is not None:        # decode: per-token positions
            cos, sin = cos[positions], sin[positions]   # (B, 1, half)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if kv_cache is not None:             # decode step
        kc, vc = kv_cache
        cache_insert(kc, k, cache_len)
        cache_insert(vc, v, cache_len)
        o = ops.decode_attention(q, kc.to(cd), vc.to(cd), cache_len + 1)
    else:                                # prefill, causal
        o = ops.flash_attention(q, k, v, causal=True)
    out = o.reshape(b, s, cfg.n_heads * hd) @ p["wo"].to(cd)
    return out, kv_cache


def cache_insert(cache, new, idx, *, mode: str = "scatter"):
    """Write new (B, 1, KV, D) at per-batch position idx into cache
    (B, S, KV, D), in place (the reference returns a new array; updating in
    place saves a copy of the cache per layer and tick). Returns cache.

    "scatter" writes only the B rows; the caller guarantees idx < S
    (``model.make_ctx`` checks it), since an index past the end raises on
    the CPU and faults the device. "onehot" rewrites every row with the
    reference's one-hot blend, which drops idx >= S as the reference does.
    """
    if mode == "scatter":
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, idx.long()] = new[:, 0].to(cache.dtype)
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


def mlp_block(p, x):
    cd = x.dtype
    g = F.silu(x @ p["w_gate"].to(cd))
    u = x @ p["w_up"].to(cd)
    return (g * u) @ p["w_down"].to(cd)
