"""Public (B, S, H, D) adapters for the kernels (the port of
``repro/kernels/ops.py``: ``flash_attention``, ``decode_attention``,
``wkv6`` and ``mamba2_ssd``).

The JAX adapters transpose to (B, H, S, D) around the Pallas calls. Here
``permute`` only relabels strides: the kernels read the model's (B, S, H, D)
activations and (B, S, KV, D) caches in place, so no layer of any tick
copies its cache and no prefill copies its activations.

Each adapter passes its kernel's one knob through (``group``, ``split``,
``value_tile``, ``state_tile``) when it is given; None keeps the kernel's
own rule. No model, serving or training module passes one: the autotuner
(``core/provision/autotune.py``) is their only caller.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba2_ssd as _ssd
from repro_torch.kernels import wkv6 as _wkv


def _knob(name: str, value) -> dict:
    """The wrapper's keyword for a knob that was given, else none."""
    return {} if value is None else {name: value}


def flash_attention(q, k, v, *, causal: bool = True, group=None):
    """q: (B, S, H, D); k, v: (B, S, KV, D) -> (B, S, H, D)."""
    o = _fa.flash_attention_bhsd(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
                                 v.permute(0, 2, 1, 3), causal=causal,
                                 **_knob("group", group))
    return o.permute(0, 2, 1, 3)


def decode_attention(q, k_cache, v_cache, cache_len, *, split=None,
                     return_lse: bool = False):
    """q: (B, 1, H, D); caches (B, S, KV, D); cache_len (B,) ->
    (B, 1, H, D); with ``return_lse`` the partial softmax (o fp32
    (B, 1, H, D), lse fp32 (B, H)) of ``decode_attention_bhd``."""
    out = _dec.decode_attention_bhd(q[:, 0], k_cache.permute(0, 2, 1, 3),
                                    v_cache.permute(0, 2, 1, 3), cache_len,
                                    **_knob("split", split),
                                    **({"return_lse": True} if return_lse
                                       else {}))
    if return_lse:
        return out[0][:, None], out[1]
    return out[:, None]


def wkv6(r, k, v, logw, u, *, value_tile=None):
    """r, k, v, logw: (B, S, H, K); u: (H, K) -> (B, S, H, K)."""
    tr = lambda a: a.permute(0, 2, 1, 3)
    return tr(_wkv.wkv6_bhsk(tr(r), tr(k), tr(v), tr(logw), u,
                             **_knob("value_tile", value_tile)))


def mamba2_ssd(x, dt, A, B, C, D, *, state_tile=None):
    """x: (B, S, H, P); dt: (B, S, H); B, C: (B, S, G, N); A, D: (H,) ->
    (B, S, H, P)."""
    y = _ssd.ssd_bhsp(x.permute(0, 2, 1, 3), dt.permute(0, 2, 1), A,
                      B.permute(0, 2, 1, 3), C.permute(0, 2, 1, 3), D,
                      **_knob("state_tile", state_tile))
    return y.permute(0, 2, 1, 3)
