"""RWKV-6 (Finch) blocks (the port of ``repro/models/rwkv.py``): time-mix with
data-dependent decay, and channel-mix.

Prefill runs the WKV recurrence through ``ops.wkv6`` (the CUDA kernel on
the card, its plain version on the CPU); train mode through
``wkv6_chunked``, plain torch that autograd differentiates, as the
reference trains through its jnp ``wkv6_chunked`` (the kernel has no
backward); decode carries per-layer state, a (B, H, K, K) fp32 wkv state
and the last token of each sub-block, and steps it with ``wkv6_recurrent``
in plain torch, as the reference does.

Recurrence per head (K = V = head_dim):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with w_t in (0,1)^K data-dependent (decay LoRA) and u a learned per-channel
bonus.

On a mesh (``mesh``: a ``spmd.MeshCtx``) a layer takes this rank's shards
under ``param_specs``: the column shards of wr, wk, wv and wg (its heads)
and of cm_wk and cm_wr, the row shards of wo and cm_wv, its heads' ln_x;
the WKV6 kernel and the decode recurrence run at the rank's heads, and the
decode state holds the rank's heads of the wkv state (the last-token rows
stay whole).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.blocks import dense_init
from repro_torch.sharding import spmd as S

# the time mix's replicated leaves: every rank reads them, but only for its
# own heads' part of the output, so their gradients are summed over the
# model axis (``tp_copy``); the last three are read at the rank's heads
TM_SHARED = ("mu", "shift_lora_a", "shift_lora_b", "decay_lora_a",
             "decay_lora_b", "decay_base", "bonus_u")


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


def _decay(p, xw, mesh=None):
    """Per-token log decay log(w_t) <= 0, (B, S, D) in fp32: the LoRA in the
    compute dtype, then -exp(decay_base + lora) in fp32; on a mesh at this
    rank's columns (its heads)."""
    lora = torch.tanh(xw @ p["decay_lora_a"].to(xw.dtype)) \
        @ S.tp_cols(p["decay_lora_b"], mesh).to(xw.dtype)
    return -torch.exp(S.tp_cols(p["decay_base"], mesh).float()
                      + lora.float())


def _group_norm_heads(x, scale, n_heads, eps=1e-5):
    """GroupNorm over each head's channels, in fp32, scale only. x: (B, S, D)."""
    b, s, d = x.shape
    hx = x.reshape(b, s, n_heads, d // n_heads).float()
    mu = hx.mean(-1, keepdim=True)
    var = (hx - mu).square().mean(-1, keepdim=True)
    hx = (hx - mu) * torch.rsqrt(var + eps)
    return (hx.reshape(b, s, d) * scale).to(x.dtype)


CHUNK, SUB = 64, 16   # wkv6_chunked: tokens per chunk and per sub-chunk


def wkv6_chunked(r, k, v, logw, u):
    """Chunk-parallel WKV6 for train mode (the port of the reference's
    ``wkv6_chunked``), in plain torch, differentiated by autograd.

    r, k, v: (B, S, H, K); logw: (B, S, H, K) fp32, <= 0; u: (H, K).
    Returns y (B, S, H, K) in r's dtype; fp32 inside. Any S >= 1: the
    sequence is zero-padded to whole chunks (logw 0, k 0: a padded token
    changes nothing before it) and the padding's outputs are dropped.

    The two-level chunking of ``csrc/wkv6.cu`` and of gated linear
    attention (Yang et al., 2023): chunks of CHUNK = 64 tokens split into
    sub-chunks of SUB = 16. Within a chunk, with ce the exclusive and cum
    the inclusive cumulative log-decay per channel, token j reaches token
    i > j decayed by exp(ce_i - cum_j). Between sub-chunks that factors
    through the later sub-chunk's first token s, as
    exp(ce_i - ce_s) * exp(ce_s - cum_j), both exponents sums of logw <= 0,
    so the terms are matmuls of (B, H, ., K) operands; only the 16 x 16
    diagonal blocks take the per-channel (B, H, ., 16, 16, K) pairwise
    form, masked before the exp. Between chunks a (K x K) state is carried,
    decayed by exp of the chunk's total. No exponent is positive, so no
    factor overflows: the reference's half-shifted factors do once a
    chunk's log-decay passes about -176 (ROADMAP C). The chunk of 64 is the
    kernel's; sub-chunks of 16 keep the pairwise term at 16 K floats a
    token (2.1 GB a tensor for a rwkv6-7b layer at 4 x 2048), where one
    64-token pairwise form would take four times that. The backward is
    autograd's, with no hand-written one: a train step of rwkv6-7b at full
    width, 8 layers, 4 x 2048 tokens and remat "full" peaked at 50.1 GB on
    an 80 GB H100, 36.7 GB of it params, grads and AdamW moments."""
    with torch.profiler.record_function("wkv6_chunked"):
        b, s, h, dk = r.shape
        nc = -(-s // CHUNK)
        nsub = CHUNK // SUB

        def chunks(a):   # (B, S, H, K) -> (B, H, nc, CHUNK, K), fp32
            a = F.pad(a.float(), (0, 0, 0, 0, 0, nc * CHUNK - s))
            return a.view(b, nc, CHUNK, h, dk).permute(0, 3, 1, 2, 4)

        rc, kc, vc, lw = (chunks(a) for a in (r, k, v, logw))
        cum = lw.cumsum(3)                                   # inclusive
        ce = F.pad(cum[:, :, :, :-1], (0, 0, 1, 0))          # exclusive
        tot = cum[:, :, :, -1]                               # (B, H, nc, K)

        # the state before each chunk: S_{c+1} = exp(tot_c) S_c + delta_c
        delta = (kc * torch.exp(tot[:, :, :, None] - cum)).transpose(-1, -2) \
            @ vc                                             # (B, H, nc, K, K)
        states = [torch.zeros_like(delta[:, :, 0])]
        for c in range(nc - 1):
            states.append(torch.exp(tot[:, :, c])[..., None] * states[-1]
                          + delta[:, :, c])
        y = (rc * torch.exp(ce)) @ torch.stack(states, 2)    # earlier chunks

        # earlier sub-chunks of the chunk, through each sub-chunk's first
        # token: exp(ce_i - ce_s) on r, exp(ce_s - cum_j) on k
        sub = lambda a: a.view(b, h, nc, nsub, SUB, dk)
        rs, ks, vs, cs, es = (sub(a) for a in (rc, kc, vc, cum, ce))
        rq = rs * torch.exp(es - es[:, :, :, :, :1])
        ys = [torch.zeros_like(vs[:, :, :, 0])]
        for a in range(1, nsub):
            first = a * SUB
            kq = kc[:, :, :, :first] * torch.exp(
                ce[:, :, :, first:first + 1] - cum[:, :, :, :first])
            ys.append((rq[:, :, :, a] @ kq.transpose(-1, -2))
                      @ vc[:, :, :, :first])
        y = y + torch.stack(ys, 3).view_as(y)

        # the diagonal blocks, pairwise per channel, and the bonus u
        lower = torch.ones(SUB, SUB, dtype=torch.bool,
                           device=r.device).tril(-1)[:, :, None]
        diff = es[..., :, None, :] - cs[..., None, :, :]     # (., i, j, K)
        dec = torch.exp(torch.where(lower, diff, float("-inf")))
        att = (rs[..., :, None, :] * dec * ks[..., None, :, :]).sum(-1)
        y = y + (att @ vs).view_as(y)
        bonus = (rc * u.float()[None, :, None, None, :] * kc).sum(
            -1, keepdim=True)
        y = y + bonus * vc
        y = y.permute(0, 2, 3, 1, 4).reshape(b, nc * CHUNK, h, dk)[:, :s]
        return y.to(r.dtype)


def wkv6_recurrent(r, k, v, logw, u, state):
    """Single-token decode. r, k, v, logw: (B, 1, H, K); u: (H, K); state
    (B, H, K, K) fp32, updated in place. Returns (y (B, 1, H, K), state)."""
    rt, kt, vt, lwt = (a.float()[:, 0] for a in (r, k, v, logw))   # (B, H, K)
    kv = torch.einsum("bhk,bhv->bhkv", kt, vt)
    y = torch.einsum("bhk,bhkv->bhv", rt,
                     state + u.float()[None, :, :, None] * kv)
    state.mul_(torch.exp(lwt)[..., None]).add_(kv)
    return y[:, None].to(r.dtype), state


def rwkv_time_mix(p, x, cfg: ArchConfig, *, state=None, last_x=None,
                  train=False, mesh=None):
    """Time-mix sub-block. state: the layer's wkv state for decode (updated
    in place), None for prefill and train mode; ``train`` takes
    ``wkv6_chunked`` in place of the kernel. mesh: this rank's shards (the
    module docstring); the leaves of ``TM_SHARED`` and x pass ``tp_copy``,
    and the output of its wo rows is summed over the model axis. Returns
    (out, state)."""
    hd = cfg.rwkv.head_dim
    b, s, _ = x.shape
    cd = x.dtype
    if mesh is not None and mesh.tp > 1:
        p = {**p, **{k: S.tp_copy(p[k], mesh) for k in TM_SHARED}}
    x = S.tp_copy(x, mesh)
    xr, xk, xv, xw, xg = _ddlerp(p, x, _token_shift(x, last_x))
    r = xr @ p["wr"].to(cd)
    cols = r.shape[-1]
    h = cols // hd
    r = r.view(b, s, h, hd)
    k = (xk @ p["wk"].to(cd)).view(b, s, h, hd)
    v = (xv @ p["wv"].to(cd)).view(b, s, h, hd)
    g = F.silu(xg @ p["wg"].to(cd))
    logw = _decay(p, xw, mesh).view(b, s, h, hd)
    u = S.tp_cols(p["bonus_u"], mesh).view(h, hd)
    if train:
        y = wkv6_chunked(r, k, v, logw, u)
    elif state is None:
        y = ops.wkv6(r, k, v, logw, u)
    else:
        y, state = wkv6_recurrent(r, k, v, logw, u, state)
    y = _group_norm_heads(y.reshape(b, s, cols), p["ln_x"].float(), h)
    return S.tp_reduce((y * g) @ p["wo"].to(cd), mesh), state


def rwkv_channel_mix(p, x, *, last_x=None, mesh=None):
    """Channel-mix sub-block. On a mesh: the column shards of cm_wk and
    cm_wr and the row shard of cm_wv; the receptance gate comes out at
    this rank's d columns, so the cm_wv product's partial sums are
    reduce-scattered to the same columns (their backward gathers), the
    product is taken there and gathered whole."""
    cd = x.dtype
    mu = S.tp_copy(p["cm_mu"], mesh)
    x = S.tp_copy(x, mesh)
    dx = _token_shift(x, last_x) - x
    xk = x + dx * mu[0].to(cd)
    xr = x + dx * mu[1].to(cd)
    k = F.relu(xk @ p["cm_wk"].to(cd)).square()
    kv = S.tp_reduce_scatter(k @ p["cm_wv"].to(cd), mesh, -1)
    return S.tp_gather(torch.sigmoid(xr @ p["cm_wr"].to(cd)) * kv, mesh, -1)
