"""Public (B, S, H, D) adapters for the attention kernels (the port of
``repro/kernels/ops.py``'s ``flash_attention`` and ``decode_attention``).

The JAX adapters transpose to (B, H, S, D) around the Pallas calls. Here
``permute`` only relabels strides: the kernels read the model's (B, S, H, D)
activations and (B, S, KV, D) caches in place, so no layer of any tick
copies its cache.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, S, H, D); k, v: (B, S, KV, D) -> (B, S, H, D)."""
    o = _fa.flash_attention_bhsd(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
                                 v.permute(0, 2, 1, 3), causal=causal)
    return o.permute(0, 2, 1, 3)


def decode_attention(q, k_cache, v_cache, cache_len):
    """q: (B, 1, H, D); caches (B, S, KV, D); cache_len (B,) ->
    (B, 1, H, D)."""
    o = _dec.decode_attention_bhd(q[:, 0], k_cache.permute(0, 2, 1, 3),
                                  v_cache.permute(0, 2, 1, 3), cache_len)
    return o[:, None]
