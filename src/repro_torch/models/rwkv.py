"""RWKV-6 (Finch) blocks (the port of ``repro/models/rwkv.py``): time-mix with
data-dependent decay, and channel-mix.

Prefill runs the WKV recurrence through ``ops.wkv6`` (the CUDA kernel on
the card, its plain version on the CPU); decode carries per-layer state,
a (B, H, K, K) fp32 wkv state and the last token of each sub-block, and
steps it with ``wkv6_recurrent`` in plain torch, as the reference does.

Recurrence per head (K = V = head_dim):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with w_t in (0,1)^K data-dependent (decay LoRA) and u a learned per-channel
bonus.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.blocks import dense_init


def init_rwkv_layer(cfg: ArchConfig, gen: torch.Generator, lead=()):
    r = cfg.rwkv
    d = cfg.d_model
    dev = gen.device

    def full(shape, value):
        return torch.full((*lead, *shape), value, device=dev)

    return {
        "mu": full((6, d), 0.5),                # x-base + r, k, v, w, g
        # the reference's _dense_init takes fan_in = shape[0], which is 5
        # (the branch count) for this (5, d, lora) weight; kept for parity
        "shift_lora_a": dense_init(gen, (*lead, 5, d, r.lora_shift), fan_in=5),
        "shift_lora_b": full((5, r.lora_shift, d), 0.0),
        "decay_lora_a": dense_init(gen, (*lead, d, r.lora_decay)),
        "decay_lora_b": full((r.lora_decay, d), 0.0),
        "decay_base": full((d,), -6.0),
        "bonus_u": full((d,), 0.0),
        "wr": dense_init(gen, (*lead, d, d)),
        "wk": dense_init(gen, (*lead, d, d)),
        "wv": dense_init(gen, (*lead, d, d)),
        "wg": dense_init(gen, (*lead, d, d)),
        "wo": dense_init(gen, (*lead, d, d)),
        "ln_x": full((d,), 1.0),                # per-head group norm scale
        "cm_mu": full((2, d), 0.5),
        "cm_wk": dense_init(gen, (*lead, d, cfg.d_ff)),
        "cm_wv": dense_init(gen, (*lead, cfg.d_ff, d)),
        "cm_wr": dense_init(gen, (*lead, d, d)),
    }


def _token_shift(x, last=None):
    """Shift right by one along seq; ``last`` (B, 1, D) fills position 0."""
    last = torch.zeros_like(x[:, :1]) if last is None else last.to(x.dtype)
    return torch.cat([last, x[:, :-1]], dim=1)


def _ddlerp(p, x, xs):
    """RWKV-6 data-dependent token-shift interpolation: the five mixed
    inputs (r, k, v, w, g), each
        x + (xs - x) * (mu_i + lora_i(x + (xs - x) * mu_x))."""
    cd = x.dtype
    dx = xs - x
    base = x + dx * p["mu"][0].to(cd)
    outs = []
    for i in range(5):
        lora = torch.tanh(base @ p["shift_lora_a"][i].to(cd)) \
            @ p["shift_lora_b"][i].to(cd)
        outs.append(x + dx * (p["mu"][i + 1].to(cd) + lora))
    return outs


def _decay(p, xw):
    """Per-token log decay log(w_t) <= 0, (B, S, D) in fp32: the LoRA in the
    compute dtype, then -exp(decay_base + lora) in fp32."""
    lora = torch.tanh(xw @ p["decay_lora_a"].to(xw.dtype)) \
        @ p["decay_lora_b"].to(xw.dtype)
    return -torch.exp(p["decay_base"].float() + lora.float())


def _group_norm_heads(x, scale, n_heads, eps=1e-5):
    """GroupNorm over each head's channels, in fp32, scale only. x: (B, S, D)."""
    b, s, d = x.shape
    hx = x.reshape(b, s, n_heads, d // n_heads).float()
    mu = hx.mean(-1, keepdim=True)
    var = (hx - mu).square().mean(-1, keepdim=True)
    hx = (hx - mu) * torch.rsqrt(var + eps)
    return (hx.reshape(b, s, d) * scale).to(x.dtype)


def wkv6_recurrent(r, k, v, logw, u, state):
    """Single-token decode. r, k, v, logw: (B, 1, H, K); u: (H, K); state
    (B, H, K, K) fp32, updated in place. Returns (y (B, 1, H, K), state)."""
    rt, kt, vt, lwt = (a.float()[:, 0] for a in (r, k, v, logw))   # (B, H, K)
    kv = torch.einsum("bhk,bhv->bhkv", kt, vt)
    y = torch.einsum("bhk,bhkv->bhv", rt,
                     state + u.float()[None, :, :, None] * kv)
    state.mul_(torch.exp(lwt)[..., None]).add_(kv)
    return y[:, None].to(r.dtype), state


def rwkv_time_mix(p, x, cfg: ArchConfig, *, state=None, last_x=None):
    """Time-mix sub-block. state: the layer's wkv state for decode (updated
    in place), None for prefill. Returns (out, state)."""
    hd = cfg.rwkv.head_dim
    b, s, d = x.shape
    h = d // hd
    cd = x.dtype
    xr, xk, xv, xw, xg = _ddlerp(p, x, _token_shift(x, last_x))
    r = (xr @ p["wr"].to(cd)).view(b, s, h, hd)
    k = (xk @ p["wk"].to(cd)).view(b, s, h, hd)
    v = (xv @ p["wv"].to(cd)).view(b, s, h, hd)
    g = F.silu(xg @ p["wg"].to(cd))
    logw = _decay(p, xw).view(b, s, h, hd)
    u = p["bonus_u"].view(h, hd)
    if state is None:
        y = ops.wkv6(r, k, v, logw, u)
    else:
        y, state = wkv6_recurrent(r, k, v, logw, u, state)
    y = _group_norm_heads(y.reshape(b, s, d), p["ln_x"].float(), h)
    return (y * g) @ p["wo"].to(cd), state


def rwkv_channel_mix(p, x, *, last_x=None):
    cd = x.dtype
    dx = _token_shift(x, last_x) - x
    xk = x + dx * p["cm_mu"][0].to(cd)
    xr = x + dx * p["cm_mu"][1].to(cd)
    k = F.relu(xk @ p["cm_wk"].to(cd)).square()
    return torch.sigmoid(xr @ p["cm_wr"].to(cd)) * (k @ p["cm_wv"].to(cd))
