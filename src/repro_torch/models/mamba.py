"""Mamba-2 (SSD) block (the port of ``repro/models/mamba.py``): projections ->
causal depthwise conv -> selective state space scan -> gated RMSNorm ->
out projection.

Prefill runs the scan through ``ops.mamba2_ssd`` (the CUDA kernel on the
card, its plain version on the CPU); train mode through ``ssd_chunked``,
plain torch that autograd differentiates, as the reference trains through
its jnp ``ssd_chunked`` (the kernel has no backward); decode steps a
(B, H, N, P) fp32 SSM state and a (B, W-1, C) conv state with
``ssd_recurrent`` in plain torch, as the reference does. Both states are
updated in place.

Recurrence per head (state N x P, P = head_dim, scalar decay per head):
    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t^T
    y_t = C_t^T h_t + D * x_t
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.blocks import dense_init
from repro_torch.sharding import spmd as S

# the block's replicated leaves, which a rank reads for its own heads' part
# of the output only: their gradients are summed over the model axis
SSM_SHARED = ("B_proj", "C_proj", "conv_BC", "conv_b_BC", "dt_proj",
              "dt_bias", "A_log", "D")


def init_mamba_layer(cfg: ArchConfig, gen: torch.Generator, lead=()):
    """Separate z, x, B, C and dt projections, as in the reference.

    The reference draws ``out_proj`` from the key of ``z_proj``
    (``ks[1]`` twice); both have d x d_inner elements, so its values are
    z_proj's in the same flat order, scaled by 1/sqrt(d_inner) in place of
    1/sqrt(d). The port copies that, so its random-init models have the
    reference's weight statistics."""
    mc = cfg.mamba
    d = cfg.d_model
    di = mc.d_inner(d)
    nh = mc.n_heads(d)
    gn = mc.n_groups * mc.d_state
    dev = gen.device
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * torch.rand((*lead, nh), generator=gen,
                                               device=dev))
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, device=dev))
    z_proj = dense_init(gen, (*lead, d, di))
    return {
        "z_proj": z_proj,
        "x_proj": dense_init(gen, (*lead, d, di)),
        "B_proj": dense_init(gen, (*lead, d, gn)),
        "C_proj": dense_init(gen, (*lead, d, gn)),
        "dt_proj": dense_init(gen, (*lead, d, nh)),
        "conv_x": 0.1 * torch.randn((*lead, mc.d_conv, di), generator=gen,
                                    device=dev),
        "conv_b_x": torch.zeros((*lead, di), device=dev),
        "conv_BC": 0.1 * torch.randn((*lead, mc.d_conv, 2 * gn),
                                     generator=gen, device=dev),
        "conv_b_BC": torch.zeros((*lead, 2 * gn), device=dev),
        "A_log": a_log.expand(*lead, nh).clone(),
        "D": torch.ones((*lead, nh), device=dev),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),   # inverse softplus
        "gate_norm": torch.ones((*lead, di), device=dev),
        "out_proj": z_proj.reshape(*lead, di, d) * math.sqrt(d / di),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv as shifted adds in x's dtype. x: (B, S, C);
    w: (W, C). state: (B, W-1, C) previous inputs for decode, zeros for
    prefill. Returns (silu(y), new_state).

    The reference pads prefill with ``zeros_like(x[:, :W-1])``, which has
    only S rows when S < W - 1, and its output is then empty; the port pads
    with W - 1 rows whatever S is."""
    wlen = w.shape[0]
    pad = x.new_zeros((x.shape[0], wlen - 1, x.shape[2])) if state is None \
        else state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                   # (B, S+W-1, C)
    s = x.shape[1]
    y = xp[:, :s] * w[0].to(x.dtype)
    for i in range(1, wlen):
        y = y + xp[:, i:i + s] * w[i].to(x.dtype)
    y = y + b.to(x.dtype)
    return F.silu(y), xp[:, -(wlen - 1):]


CHUNK = 64   # ssd_chunked's tokens per chunk


def ssd_chunked(x, dt, A, B, C, D):
    """Chunk-parallel SSD for train mode (the port of the reference's
    ``ssd_chunked``), in plain torch, differentiated by autograd.

    x: (B, S, H, P); dt: (B, S, H) fp32; A, D: (H,); B, C: (B, S, G, N),
    head h reading group h // (H / G). Returns y (B, S, H, P) in x's dtype;
    fp32 inside. Any S >= 1: the sequence is zero-padded to whole chunks
    (dt 0: a padded token changes nothing before it) and the padding's
    outputs are dropped.

    Within a chunk, with cum the inclusive cumulative dt A of a head, token
    j reaches token t >= j decayed by exp(cum_t - cum_j), the difference
    masked before the exp; a chunk's tokens reach the next chunk through
    an (N x P) state decayed by exp of the chunk's total, and every state
    term's decay, exp(tot - cum_j) and exp(cum_t), is of a sum of dt A <= 0.
    No exponent is positive, so no factor overflows: the reference's
    half-shifted factors do once a chunk's sum passes about -176, which
    zamba2-7b's own init reaches at its chunk of 256 (ROADMAP C). B and C
    stay per group (C Bᵀ once per group, not per head). A chunk of 64, the
    kernel's: the (L x L) pairwise decay and the per-chunk states then
    each hold 64 floats a token and head, as many as x at P = 64 (at 256
    the pairwise term would hold four times x)."""
    with torch.profiler.record_function("ssd_chunked"):
        b, s, h, p_ = x.shape
        g, n = B.shape[2], B.shape[3]
        reps = h // g
        nc = -(-s // CHUNK)
        pad = nc * CHUNK - s

        def chunks(a):   # (B, S, X, F) -> (B, X, nc, CHUNK, F), fp32
            a = F.pad(a.float(), (0, 0, 0, 0, 0, pad))
            return a.view(b, nc, CHUNK, a.shape[2], a.shape[3]).permute(
                0, 3, 1, 2, 4)

        dtc = F.pad(dt.float(), (0, 0, 0, pad)).view(b, nc, CHUNK, h)
        dtc = dtc.permute(0, 3, 1, 2)                        # (B, H, nc, L)
        # heads as (G, reps), so that B and C broadcast over a group's heads
        cum = (dtc * A.float()[None, :, None, None]).cumsum(-1).view(
            b, g, reps, nc, CHUNK)
        tot = cum[..., -1]                                   # (B, G, r, nc)
        xd = (chunks(x) * dtc[..., None]).view(b, g, reps, nc, CHUNK, p_)
        Bc, Cc = (chunks(a)[:, :, None] for a in (B, C))  # (B, G, 1, nc, L, N)

        lower = torch.ones(CHUNK, CHUNK, dtype=torch.bool,
                           device=x.device).tril()
        diff = cum[..., :, None] - cum[..., None, :]         # (., t, j)
        dec = torch.exp(torch.where(lower, diff, float("-inf")))
        y = ((Cc @ Bc.transpose(-1, -2)) * dec) @ xd         # this chunk

        # the state before each chunk: h_{c+1} = exp(tot_c) h_c + delta_c
        delta = Bc.transpose(-1, -2) @ (
            xd * torch.exp(tot[..., None] - cum)[..., None])  # (., nc, N, P)
        states = [torch.zeros_like(delta[:, :, :, 0])]
        for c in range(nc - 1):
            states.append(torch.exp(tot[..., c])[..., None, None] * states[-1]
                          + delta[:, :, :, c])
        y = y + torch.exp(cum)[..., None] * (Cc @ torch.stack(states, 3))

        y = y.view(b, h, nc * CHUNK, p_).transpose(1, 2)[:, :s]
        y = y + x.float() * D.float()[None, None, :, None]
        return y.to(x.dtype)


def ssd_recurrent(x, dt, A, B, C, D, state):
    """Single-token decode. x: (B, 1, H, P); dt: (B, 1, H); B, C:
    (B, 1, G, N); state (B, H, N, P) fp32, updated in place. Returns
    (y (B, 1, H, P), state)."""
    reps = x.shape[2] // B.shape[2]
    xf = x.float()[:, 0]
    xt = xf * dt.float()[:, 0, :, None]                         # (B, H, P)
    bt = B.float()[:, 0].repeat_interleave(reps, dim=1)         # (B, H, N)
    ct = C.float()[:, 0].repeat_interleave(reps, dim=1)
    a = torch.exp(dt.float()[:, 0] * A.float()[None])           # (B, H)
    state.mul_(a[..., None, None]).add_(
        torch.einsum("bhn,bhp->bhnp", bt, xt))
    y = torch.einsum("bhn,bhnp->bhp", ct, state) \
        + xf * D.float()[None, :, None]
    return y[:, None].to(x.dtype), state


def _split_conv(conv, di: int, mesh):
    """The decode conv state's x part (this rank's d_inner columns) and its
    B and C part (every channel). On a mesh the state's channels (d_inner
    of x, then B's and C's) split evenly over the model axis under
    ``decode_state_specs``, which does not follow the rank's x columns
    (zamba2-7b at tp 2: 3648 channels a rank against 3584 x columns), so
    the state is gathered whole first."""
    if mesh is None or mesh.tp == 1:
        return conv[..., :di], conv[..., di:]
    whole = S.all_gather(conv, mesh.model_group, -1)
    x0 = mesh.tp_rank * di
    return whole[..., x0:x0 + di], whole[..., di * mesh.tp:]


def _write_conv(conv, conv_x, conv_bc, di: int, mesh) -> None:
    """The new conv state into ``conv`` in place; on a mesh every rank's x
    part gathered, then this rank's even share of the channels kept."""
    if mesh is None or mesh.tp == 1:
        conv[..., :di].copy_(conv_x)
        conv[..., di:].copy_(conv_bc)
        return
    whole = torch.cat([S.all_gather(conv_x, mesh.model_group, -1),
                       conv_bc.to(conv_x.dtype)], -1)
    conv.copy_(whole.chunk(mesh.tp, -1)[mesh.tp_rank])


def mamba_block(p, x, cfg: ArchConfig, *, state=None, train=False,
                mesh=None):
    """state: (ssm_state, conv_state) for decode, updated in place; None for
    prefill and train mode; ``train`` takes ``ssd_chunked`` in place of the
    kernel. Returns (out, state).

    On a mesh (``mesh``: a ``spmd.MeshCtx``) p holds this rank's shards
    under ``param_specs``: the column shards of z_proj, x_proj and conv_x,
    its d_inner columns of conv_b_x and gate_norm (whole SSD heads), its
    rows of out_proj, whose output is summed over the model axis. The
    replicated leaves of ``SSM_SHARED`` (B and C, dt, A and D, read at the
    rank's heads) and x pass ``tp_copy``, since each rank reads them for
    its own heads' part of the output. The SSD scan runs at the rank's
    heads; the gated RMSNorm's sum of squares over d_inner is summed over
    the model axis both ways (``tp_sum``); the decode state holds the
    rank's heads of the SSM state and an even share of the conv state's
    channels (``_split_conv``)."""
    mc = cfg.mamba
    b, s, d = x.shape
    gn = mc.n_groups * mc.d_state
    cd = x.dtype
    split = mesh is not None and mesh.tp > 1
    if split:
        if mc.n_groups > 1:      # a rank's heads would read other groups
            raise NotImplementedError(
                f"{cfg.name}: {mc.n_groups} B/C groups on a mesh")
        p = {**p, **{k: S.tp_copy(p[k], mesh) for k in SSM_SHARED}}
    x = S.tp_copy(x, mesh)

    z = x @ p["z_proj"].to(cd)
    xs = x @ p["x_proj"].to(cd)
    di = xs.shape[-1]
    nh = di // mc.head_dim
    bc = torch.cat([x @ p["B_proj"].to(cd), x @ p["C_proj"].to(cd)], dim=-1)
    dt_raw = x @ S.tp_cols(p["dt_proj"], mesh).to(cd)
    ssm, conv = (None, None) if state is None else state
    conv_x, conv_bc = (None, None) if conv is None \
        else _split_conv(conv, di, mesh)
    xs, conv_x = _causal_conv(xs, p["conv_x"], p["conv_b_x"], conv_x)
    bc, conv_bc = _causal_conv(bc, p["conv_BC"], p["conv_b_BC"], conv_bc)
    if conv is not None:
        _write_conv(conv, conv_x, conv_bc, di, mesh)
    xs = xs.view(b, s, nh, mc.head_dim)
    Bm = bc[..., :gn].reshape(b, s, mc.n_groups, mc.d_state)
    Cm = bc[..., gn:].reshape(b, s, mc.n_groups, mc.d_state)
    # F.softplus returns x itself above x = 20, where JAX's softplus gives
    # x + log1p(exp(-x)): the two differ by less than 2.1e-9
    dt = F.softplus(dt_raw.float()
                    + S.tp_cols(p["dt_bias"], mesh).float())
    A = -torch.exp(S.tp_cols(p["A_log"], mesh).float())
    Dv = S.tp_cols(p["D"], mesh)
    if train:
        y = ssd_chunked(xs, dt, A, Bm, Cm, Dv)
    elif ssm is None:
        y = ops.mamba2_ssd(xs, dt, A, Bm, Cm, Dv)
    else:
        y, _ = ssd_recurrent(xs, dt, A, Bm, Cm, Dv, ssm)
    # gated RMSNorm (Mamba-2): norm(y * silu(z)) in fp32, the mean of the
    # squares over the whole d_inner
    yf = (y.reshape(b, s, di) * F.silu(z)).float()
    ms = S.tp_sum(yf.square().sum(-1, keepdim=True), mesh) \
        / (di * (mesh.tp if mesh else 1))
    y = (yf * torch.rsqrt(ms + 1e-5) * p["gate_norm"]).to(cd)
    return S.tp_reduce(y @ p["out_proj"].to(cd), mesh), state
