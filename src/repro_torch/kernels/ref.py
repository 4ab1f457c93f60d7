"""Literal O(S^2) oracles for the attention kernels (the port of
``repro/kernels/ref.py``'s ``attention_ref`` and ``decode_attention_ref``).

Deliberately the most literal implementations, GQA-expanded with
``repeat_interleave``, so kernel bugs cannot hide in shared structure.
"""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True):
    """q: (B, S, H, D); k, v: (B, S, KV, D). fp32 math, scale 1/sqrt(D)."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    kq = k.repeat_interleave(group, dim=2).float()
    vq = v.repeat_interleave(group, dim=2).float()
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kq) * d ** -0.5
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        sc = sc.masked_fill(~mask, float("-inf"))
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vq).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, cache_len):
    """q: (B, H, D); caches: (B, KV, S, D); cache_len: (B,). Scale
    1/sqrt(D)."""
    b, h, d = q.shape
    s = k_cache.shape[2]
    group = h // k_cache.shape[1]
    kq = k_cache.repeat_interleave(group, dim=1).float()
    vq = v_cache.repeat_interleave(group, dim=1).float()
    sc = torch.einsum("bhd,bhkd->bhk", q.float(), kq) * d ** -0.5
    valid = torch.arange(s, device=q.device)[None, None, :] < \
        cache_len.to(q.device)[:, None, None]
    sc = sc.masked_fill(~valid, float("-inf"))
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p, vq).to(q.dtype)
