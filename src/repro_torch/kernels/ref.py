"""Literal oracles for every kernel (the port of ``repro/kernels/ref.py``):
O(S^2) attention and decode attention, and the sequential WKV6 and Mamba-2
SSD recurrences.

Deliberately the most literal implementations, GQA-expanded with
``repeat_interleave`` and walked one token at a time, so kernel bugs cannot
hide in shared structure.
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


def wkv6_ref(r, k, v, logw, u):
    """Sequential WKV6. r, k, v, logw: (B, S, H, K); u: (H, K).
    S_t = diag(w_t) S_{t-1} + k_t^T v_t;  y_t = r_t (S_{t-1} + diag(u) k v)."""
    b, s, h, dk = r.shape
    r_, k_, v_, w_ = (a.float() for a in (r, k, v, logw))
    uf = u.float()[None, :, :, None]
    state = torch.zeros((b, h, dk, dk), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(s):
        kv = torch.einsum("bhk,bhv->bhkv", k_[:, t], v_[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", r_[:, t], state + uf * kv))
        state = torch.exp(w_[:, t])[..., None] * state + kv
    return torch.stack(ys, dim=1).to(r.dtype)


def ssd_ref(x, dt, A, B, C, D):
    """Sequential Mamba-2 SSD. x: (B, S, H, P); dt: (B, S, H); A: (H,);
    B, C: (B, S, G, N); D: (H,)."""
    b, s, h, p_ = x.shape
    reps = h // B.shape[2]
    Bh = B.float().repeat_interleave(reps, dim=2)
    Ch = C.float().repeat_interleave(reps, dim=2)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    state = torch.zeros((b, h, B.shape[3], p_), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(s):
        a = torch.exp(dtf[:, t] * Af[None])                     # (B, H)
        xd = xf[:, t] * dtf[:, t, :, None]
        state = a[..., None, None] * state + \
            torch.einsum("bhn,bhp->bhnp", Bh[:, t], xd)
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], state))
    y = torch.stack(ys, dim=1)
    return (y + xf * D.float()[None, None, :, None]).to(x.dtype)
