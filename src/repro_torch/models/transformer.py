"""Stacked layers (the port of ``repro/models/transformer.py``), uniform dense
layout only.

Params of all layers are stacked along dim 0, as in the reference; its
``lax.scan`` over layers becomes a loop over that dim. The decode state
has the same stacking: {"layers": (k, v)}, each (L, B, S, KV, D), and each
layer writes its new token into its slice in place. The periodic layouts
(VLM, hybrid) and the MoE and RWKV blocks are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as B


def build_layout(cfg: ArchConfig) -> dict:
    if cfg.family != "dense" or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: only the uniform dense layout is ported")
    return {"kind": "uniform", "block": "dense", "n": cfg.n_layers}


def init_stack(cfg: ArchConfig, gen: torch.Generator):
    layout = build_layout(cfg)
    lead = (layout["n"],)
    return {"layers": {"attn": B.init_attention(cfg, gen, lead),
                       "mlp": B.init_mlp(cfg, gen, lead),
                       "ln1": B.init_norm(cfg, lead, gen.device),
                       "ln2": B.init_norm(cfg, lead, gen.device)}}


def layer_fwd(block: str, p, x, cfg: ArchConfig, ctx: dict, state=None):
    """One dense layer. Returns (x, state); a decode state is updated in
    place."""
    if block != "dense":
        raise NotImplementedError(block)
    h = B.apply_norm(p["ln1"], x, cfg)
    o, state = B.attention_block(
        p["attn"], h, cfg, rope=ctx.get("rope"),
        positions=ctx.get("positions"), kv_cache=state,
        cache_len=ctx.get("cache_len"))
    x = x + o
    h = B.apply_norm(p["ln2"], x, cfg)
    return x + B.mlp_block(p["mlp"], h), state


def _layer(tree, i: int):
    """Layer i's params: index dim 0 of every stacked leaf (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def apply_stack(params, x, cfg: ArchConfig, ctx: dict, states=None):
    """Run all layers. states: decode state or None. Returns (x, states)."""
    layout = build_layout(cfg)
    decode = ctx["mode"] == "decode"
    for i in range(layout["n"]):
        st = None
        if decode:
            k_all, v_all = states["layers"]
            st = (k_all[i], v_all[i])
        x, _ = layer_fwd(layout["block"], _layer(params["layers"], i), x, cfg,
                         ctx, st)
    return x, states


def init_decode_state(cfg: ArchConfig, batch: int, buffer_len: int,
                      dtype=torch.bfloat16, device="cpu"):
    """Zeroed KV caches for the whole stack (bf16 by default, as in the
    reference)."""
    layout = build_layout(cfg)
    shape = (layout["n"], batch, buffer_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"layers": (torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))}
