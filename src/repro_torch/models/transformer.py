"""Stacked layers over block types (the port of ``repro/models/transformer.py``).

Layouts, as in the reference:
  uniform : all layers of one block kind, params stacked along dim 0
            -> dense (olmo-1b, qwen3-8b; musicgen-large, over frames of
               codes), moe (olmoe-1b-7b, llama4-scout) and rwkv (rwkv6-7b)
  periodic: periods of [inner_n stacked layers + one special layer], then
            trailing inner layers
            -> vlm (llama-3.2-vision-11b): (4 dense + 1 cross-attention)
               x 8, the cross-attention layers stacked (periods,)
            -> hybrid (zamba2-7b): (5 mamba + 1 *shared* attention block)
               x 13 + 3 mamba, the attention weights shared by all sites

The reference's ``lax.scan``s over layers become loops over the stacked
dims. The decode state has the same stacking as the params:
  dense, moe: {"layers": (k, v)}, each (L, B, S, KV, D)
  rwkv  : {"layers": (wkv (L, B, H, K, K) fp32, tm_last, cm_last (L, B, 1, D))}
  hybrid: {"inner": (ssm (P, I, B, H, N, Pd) fp32, conv (P, I, B, W-1, C)),
           "single": (k, v) per attention site, each (P, B, S, KV, D),
           "trailing": (ssm, conv) with a leading max(trailing, 1) dim}
  vlm   : {"inner": (k, v), each (P, I, B, S, KV, D),
           "single": the vision K/V (k, v), each (P, B, Nv, KV, D), built
                     once from params and vision and never written,
           "trailing": (k, v) with a leading max(trailing, 1) dim}
Every layer updates its slice of the decode state in place (the reference
returns new arrays; in place saves a copy of every cache and state per layer
and tick). Train mode runs every layout here. Each stacked layer (dense,
rwkv, an inner or trailing mamba layer) runs under ``ctx["remat"]``, as the
reference remats its inner scan body (one layer); the special layer of a
period (the hybrid's shared attention block, the VLM's cross-attention
layer) runs outside it, as the reference's outer scan body is not
rematerialised, and the shared block's weights gather the gradients of
every site. The RWKV and Mamba layers take their differentiable
``wkv6_chunked`` and ``ssd_chunked`` there, not the kernels. Each layer
returns its auxiliary loss beside x (MoE's load-balancing loss; None for a
block without one), and the stack sums them, as the reference's scans carry
aux; under remat the checkpointed layer returns both.

On a mesh with FSDP (``ctx["mesh"].fsdp``) params are this rank's shards
and each stacked layer's leaves are gathered whole over data where the
layer runs, inside the function that remat checkpoints: the forward holds
one whole layer at a time, the recompute gathers it again, and the
gather's backward reduce-scatters the layer's gradient
(``spmd.gather_params``). The special layers outside the inner stacks (the
hybrid's shared block, gathered once a step; the VLM's cross-attention
layer of each period) are gathered where they run.
"""
from __future__ import annotations

import functools
import itertools

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as B
from repro_torch.models import mamba as M
from repro_torch.models import rwkv as R
from repro_torch.sharding import spmd as S


def build_layout(cfg: ArchConfig) -> dict:
    """The reference's layouts. With ``cfg.moe`` set, every layer is a
    ``moe`` layer, as in the reference, whatever ``moe_every`` says
    (``layer_kinds`` and ``n_params`` count dense layers between; no config
    sets it; ROADMAP C, quirk)."""
    if cfg.family in ("vlm", "hybrid"):
        vlm = cfg.family == "vlm"
        k = cfg.cross_attn_every if vlm else cfg.hybrid_attn_every
        periods = cfg.n_layers // k
        return {"kind": "periodic", "periods": periods, "inner_n": k - 1,
                "inner_block": "dense" if vlm else "mamba",
                "single_block": "cross_attn" if vlm else "shared_attn",
                "trailing": cfg.n_layers - periods * k}
    block = "rwkv" if cfg.family == "ssm" else \
        "moe" if cfg.moe is not None else "dense"
    return {"kind": "uniform", "n": cfg.n_layers, "block": block}


def init_layer(block: str, cfg: ArchConfig, gen: torch.Generator, lead=()):
    dev = gen.device
    if block in ("dense", "shared_attn"):
        return {"attn": B.init_attention(cfg, gen, lead),
                "mlp": B.init_mlp(cfg, gen, lead),
                "ln1": B.init_norm(cfg, lead, dev),
                "ln2": B.init_norm(cfg, lead, dev)}
    if block == "moe":
        return {"attn": B.init_attention(cfg, gen, lead),
                "moe": B.init_moe(cfg, gen, lead),
                "ln1": B.init_norm(cfg, lead, dev),
                "ln2": B.init_norm(cfg, lead, dev)}
    if block == "cross_attn":        # tanh-gated; the gates start at zero
        return {"attn": B.init_attention(cfg, gen, lead, d_src=cfg.vision_dim),
                "mlp": B.init_mlp(cfg, gen, lead),
                "ln1": B.init_norm(cfg, lead, dev),
                "ln2": B.init_norm(cfg, lead, dev),
                "gate_attn": torch.zeros(lead, device=dev),
                "gate_mlp": torch.zeros(lead, device=dev)}
    if block == "rwkv":
        return {"tm": R.init_rwkv_layer(cfg, gen, lead),
                "ln1": B.init_norm(cfg, lead, dev),
                "ln2": B.init_norm(cfg, lead, dev)}
    if block == "mamba":
        return {"m": M.init_mamba_layer(cfg, gen, lead),
                "ln1": B.init_norm(cfg, lead, dev)}
    raise NotImplementedError(block)


def init_stack(cfg: ArchConfig, gen: torch.Generator, dtype_of):
    """The layers' params, each leaf of ``dtype_of`` its path in the param
    tree (e.g. ``("layers", "mlp", "w_up")``): each stacked leaf is
    allocated once in its dtype, and every layer is drawn alone in fp32
    and cast into its slice, so that making the stack holds it and one
    layer's fp32 leaves (qwen3-32b: 62.4 GB of bf16 layers and 2 GB of one
    layer's fp32, not 125 GB)."""
    layout = build_layout(cfg)

    def stacked(block, lead, path):
        """``block``'s layers stacked on ``lead``, filled in layer order."""
        def alloc(one, at):
            return {k: alloc(v, (*at, k)) if isinstance(v, dict) else
                    torch.empty((*lead, *v.shape), dtype=dtype_of((*at, k)),
                                device=v.device) for k, v in one.items()}

        def fill(tree, one, idx):
            for k, v in one.items():
                if isinstance(v, dict):
                    fill(tree[k], v, idx)
                else:
                    tree[k][idx].copy_(v)

        out = None
        for idx in itertools.product(*map(range, lead)):
            one = init_layer(block, cfg, gen)
            if out is None:
                out = alloc(one, path)
            fill(out, one, idx)
            del one              # before the next layer's draws
        return out

    if layout["kind"] == "uniform":
        return {"layers": stacked(layout["block"], (layout["n"],),
                                  ("layers",))}
    inner = layout["inner_block"]
    out = {"layers": {
        "inner": stacked(inner, (layout["periods"], layout["inner_n"]),
                         ("layers", "inner")),
        # the reference keeps one trailing layer even when there are none
        "trailing": stacked(inner, (max(layout["trailing"], 1),),
                            ("layers", "trailing"))}}
    if layout["single_block"] == "cross_attn":   # one per period
        out["layers"]["single"] = stacked("cross_attn", (layout["periods"],),
                                          ("layers", "single"))
    else:                                        # one block, shared
        out["shared_block"] = stacked("shared_attn", (), ("shared_block",))
    return out


def unused_subtrees(cfg: ArchConfig) -> tuple[str, ...]:
    """Param subtrees (``convert.flatten`` paths) that the layout holds but
    never runs: the periodic layouts' placeholder trailing layer when no
    layer trails (the hybrid's and the VLM's), which the reference keeps
    and ``jax.grad`` gives zeros."""
    layout = build_layout(cfg)
    if layout["kind"] == "periodic" and layout["trailing"] == 0:
        return ("layers/trailing",)
    return ()


def layer_fwd(block: str, p, x, cfg: ArchConfig, ctx: dict, state=None):
    """One layer. Returns (x, state, aux); a decode state is updated in
    place; aux is the layer's auxiliary loss, None for a block without
    one. On a mesh (``ctx["mesh"]``) every block runs tensor-parallel on
    this rank's shards (its heads, d_ff columns or experts) and a decode
    state is this rank's (``decode_state_specs``). The reference constrains
    each layer's output to the batch layout; here every rank's x is its own
    rows already."""
    decode = ctx["mode"] == "decode"
    train = ctx["mode"] == "train"
    mesh = ctx.get("mesh")
    if block in ("dense", "moe", "shared_attn"):
        h = B.apply_norm(p["ln1"], x, cfg)
        o, state = B.attention_block(
            p["attn"], h, cfg, rope=ctx.get("rope"),
            positions=ctx.get("positions"), kv_cache=state,
            cache_len=ctx.get("cache_len"),
            attn_impl=ctx["attn_impl"] if train else None, mesh=mesh)
        x = x + o
        h = B.apply_norm(p["ln2"], x, cfg)
        if block == "moe":
            y, aux = B.moe_block(p["moe"], h, cfg, mesh=mesh)
            return x + y, state, aux
        return x + B.mlp_block(p["mlp"], h, mesh), state, None
    if block == "cross_attn":
        h = B.apply_norm(p["ln1"], x, cfg)
        if decode:       # the vision K/V of the state, never written
            o = B.cross_attention_block(p["attn"], h, cfg, kv=state,
                                        mesh=mesh)
        else:            # the vision states, cast to the compute dtype first
            o, _ = B.attention_block(p["attn"], h, cfg,
                                     kv_src=ctx["vision"].to(h.dtype),
                                     mesh=mesh)
        # tanh of the fp32 gate, then cast, as the reference does
        x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * o
        h = B.apply_norm(p["ln2"], x, cfg)
        x = x + torch.tanh(p["gate_mlp"]).to(x.dtype) * \
            B.mlp_block(p["mlp"], h, mesh)
        return x, state, None
    if block == "rwkv":
        wkv, tm_last, cm_last = state if decode else (None, None, None)
        h = B.apply_norm(p["ln1"], x, cfg)
        o, _ = R.rwkv_time_mix(p["tm"], h, cfg, state=wkv, last_x=tm_last,
                               train=train, mesh=mesh)
        x = x + o
        h2 = B.apply_norm(p["ln2"], x, cfg)
        # channel-mix params live under the time-mix key, as in the reference
        x = x + R.rwkv_channel_mix(p["tm"], h2, last_x=cm_last, mesh=mesh)
        if decode:       # the next token shifts in this token's normed inputs
            tm_last.copy_(h[:, -1:])
            cm_last.copy_(h2[:, -1:])
        return x, state, None
    if block == "mamba":
        h = B.apply_norm(p["ln1"], x, cfg)
        o, state = M.mamba_block(p["m"], h, cfg, state=state, train=train,
                                 mesh=mesh)
        return x + o, state, None
    raise NotImplementedError(block)


def _layer(tree, i: int):
    """Index dim 0 of every leaf of a param dict or state tuple (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_layer(v, i) for v in tree)
    return tree[i]


# "dots": keep the outputs of the unbatched matmuls (the projections and
# the MLP, all ``aten.mm``) and recompute the rest, the attention einsums
# (``aten.bmm``) included: jax's dots_with_no_batch_dims_saveable
_SAVE_MM = functools.partial(create_selective_checkpoint_contexts,
                             [torch.ops.aten.mm.default])


def _maybe_remat(fn, ctx):
    """A train-mode layer under ``ctx["remat"]``: fn itself for "none";
    else fn under ``torch.utils.checkpoint``: "full" saves only its inputs
    and recomputes the layer in the backward, "dots" saves its ``aten.mm``
    outputs too."""
    pol = ctx.get("remat")
    if pol in (None, "none"):
        return fn
    if pol not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {pol!r}")
    kw = {"context_fn": _SAVE_MM} if pol == "dots" else {}
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def _add(total, aux):
    return aux if total is None else total if aux is None else total + aux


def _run(block, stacked, n, x, cfg, ctx, states, path, aux=None):
    """n stacked layers (``stacked``: the param subtree at ``path``, or a
    period's slice of it); returns (x, aux), aux summed onto ``aux``. Each
    layer's leaves are gathered over data (FSDP) inside the layer's own
    function, under remat inside the checkpoint (a leaf that FSDP shards
    along the layer dim itself, the stack at once, before the loop)."""
    mesh = ctx.get("mesh")
    stacked = S.gather_params(stacked, mesh, *path, lead=1)

    def layer(p, x, st=None):
        return layer_fwd(block, S.gather_params(p, mesh, *path), x, cfg,
                         ctx, st)

    if ctx["mode"] == "train":
        fwd = _maybe_remat(lambda p, x: layer(p, x)[::2], ctx)
        for i in range(n):
            x, a = fwd(_layer(stacked, i), x)
            aux = _add(aux, a)
        return x, aux
    for i in range(n):
        st = None if states is None else _layer(states, i)
        x, _, a = layer(_layer(stacked, i), x, st)
        aux = _add(aux, a)
    return x, aux


def apply_stack(params, x, cfg: ArchConfig, ctx: dict, states=None):
    """Run all layers. states: decode state (updated in place) or None.
    Returns (x, aux, states): aux is the sum of the layers' auxiliary
    losses, a 0-d fp32 tensor, or None where no layer has one."""
    layout = build_layout(cfg)
    decode = ctx["mode"] == "decode"
    mesh = ctx.get("mesh")

    def part(key):
        return states[key] if decode else None

    if layout["kind"] == "uniform":
        x, aux = _run(layout["block"], params["layers"], layout["n"], x, cfg,
                      ctx, part("layers"), ("layers",))
        return x, aux, states
    inner, aux = layout["inner_block"], None
    cross = layout["single_block"] == "cross_attn"
    if not cross:        # the hybrid's shared block: gathered once a step
        shared = S.gather_params(params["shared_block"], mesh,
                                 "shared_block")
    for i in range(layout["periods"]):
        x, aux = _run(inner, _layer(params["layers"]["inner"], i),
                      layout["inner_n"], x, cfg, ctx,
                      _layer(states["inner"], i) if decode else None,
                      ("layers", "inner"), aux)
        single = S.gather_params(_layer(params["layers"]["single"], i),
                                 mesh, "layers", "single") if cross \
            else shared
        x, _, a = layer_fwd(layout["single_block"], single, x, cfg, ctx,
                            _layer(states["single"], i) if decode else None)
        aux = _add(aux, a)
    x, aux = _run(inner, params["layers"]["trailing"], layout["trailing"], x,
                  cfg, ctx, part("trailing"), ("layers", "trailing"), aux)
    return x, aux, states


def init_decode_state(cfg: ArchConfig, batch: int, buffer_len: int,
                      dtype=torch.bfloat16, device="cpu", vision=None,
                      params=None):
    """Zeroed decode state for the whole stack: KV caches and last-token and
    conv states in ``dtype`` (bf16 by default, as in the reference),
    recurrent wkv and SSM states in fp32. The VLM's cross-attention layers
    hold the vision K/V instead, which need ``vision`` (B, Nv, d_src) and
    ``params``: each period's ``blocks.cross_kv`` of vision in its own
    dtype (the pipeline's fp32), cast to ``dtype``, as the reference's
    ``cross_state``, with its missing k-norm applied (ROADMAP C)."""
    layout = build_layout(cfg)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def attn_state(*lead):
        shape = (*lead, batch, buffer_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return (zeros(*shape), zeros(*shape))

    def rwkv_state(*lead):
        hd = cfg.rwkv.head_dim
        return (zeros(*lead, batch, cfg.d_model // hd, hd, hd,
                      dt=torch.float32),
                zeros(*lead, batch, 1, cfg.d_model),
                zeros(*lead, batch, 1, cfg.d_model))

    def mamba_state(*lead):
        mc = cfg.mamba
        conv_ch = mc.d_inner(cfg.d_model) + 2 * mc.n_groups * mc.d_state
        return (zeros(*lead, batch, mc.n_heads(cfg.d_model), mc.d_state,
                      mc.head_dim, dt=torch.float32),
                zeros(*lead, batch, mc.d_conv - 1, conv_ch))

    if layout["kind"] == "uniform":
        maker = rwkv_state if layout["block"] == "rwkv" else attn_state
        return {"layers": maker(layout["n"])}
    if layout["single_block"] == "shared_attn":
        return {"inner": mamba_state(layout["periods"], layout["inner_n"]),
                "single": attn_state(layout["periods"]),
                "trailing": mamba_state(max(layout["trailing"], 1))}
    if vision is None or params is None:
        raise ValueError(f"{cfg.name}: the decode state needs vision and "
                         "params for its cross-attention layers")
    return {"inner": attn_state(layout["periods"], layout["inner_n"]),
            "single": cross_state(cfg, params, torch.as_tensor(
                vision, device=device), dtype),
            "trailing": attn_state(max(layout["trailing"], 1))}


def kv_cache_keys(cfg: ArchConfig) -> tuple:
    """The entries of ``init_decode_state``'s tree that hold KV caches (the
    VLM's vision K/V, which no step writes, left out)."""
    layout = build_layout(cfg)
    if layout["kind"] == "uniform":
        return () if layout["block"] == "rwkv" else ("layers",)
    if layout["inner_block"] == "mamba":
        return ("single",)
    return ("inner", "trailing")


def cross_state(cfg: ArchConfig, params, vision, dtype, mesh=None):
    """The VLM's decode-state vision K/V, (k, v) each (P, B, Nv, KV, D):
    each period's ``blocks.cross_kv`` of vision (B, Nv, d_src) in its own
    dtype, cast to ``dtype``. On a mesh params are this rank's shards
    (each period's gathered over data, FSDP) and the K/V come out whole
    (every kv head), gathered from every rank's wk and wv columns, as
    ``decode_state_specs`` keeps them."""
    single = params["layers"]["single"]["attn"]
    kvs = [B.cross_kv(S.gather_params(_layer(single, i), mesh, "layers",
                                      "single", "attn"), vision, cfg, mesh)
           for i in range(build_layout(cfg)["periods"])]
    return tuple(torch.stack([kv[j] for kv in kvs]).to(dtype)
                 for j in range(2))


def reset_slot(states, s: int) -> None:
    """Zero slot ``s``'s recurrent state in place, for a new request: the
    RWKV wkv state and both last-token tensors, the Mamba SSM and conv
    states. KV caches are left as they are, since ``cache_len`` masks what a
    new request has not written. (The VLM's vision K/V belong to a request;
    the serving driver refuses the VLM.)"""
    if "layers" in states:
        if len(states["layers"]) == 3:     # rwkv: (wkv, tm_last, cm_last)
            for t in states["layers"]:
                t[:, s].zero_()
        return
    for t in states["inner"]:              # (periods, inner_n, B, ...)
        t[:, :, s].zero_()
    for t in states["trailing"]:           # (n, B, ...)
        t[:, s].zero_()
