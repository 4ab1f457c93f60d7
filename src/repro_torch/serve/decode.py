"""Serving steps (the port of ``repro/serve/decode.py``): prefill and
one-token decode.

There is no ``attn_impl`` switch: on CUDA tensors prefill runs the flash,
WKV6 and SSD kernels and decode attention the decode kernel (the RWKV and
Mamba decode steps and cross-attention are plain torch, as in the
reference); their plain versions serve CPU tensors only.

The sharded prefill and serve steps run them on a ``DeviceMesh`` over
"pod", "data" and "model" axes (any of them), one process per rank, as the
reference's ``dryrun.build_cell`` assembles them: params under
``param_specs`` (FSDP's layout, each layer gathered over data where it
runs, ``spmd.gather_params``; or, for the serve step's
``layout="resident"``, model-axis TP only, no FSDP, and the batch
replicated), the decode state under ``decode_state_specs`` and the batch
under ``batch_specs`` (over the batch shards, "pod" x "data"); each rank runs
the flash and decode kernels at its H/tp query heads and KV/tp KV heads,
and every rank returns the global batch's logits. Every layout runs so:
the recurrent families hold the rank's heads of their wkv and SSM states,
the VLM its vision K/V whole. Where the spec shards a KV cache's sequence
(KV heads that the model axis does not divide, or a batch that the batch
shards do not), each rank holds its positions of it, attends over them
and merges the ranks' partial softmaxes over the sequence's group
(``blocks.attention_block``): no rank gathers a cache.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ArchConfig, *, compute_dtype=torch.bfloat16,
                      device="cuda"):
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_step(params, batch):
        tokens = batch["tokens"].to(dev)          # (B, S[, K])
        ctx = M.make_ctx(cfg, tokens.shape[1], "prefill",
                         vision=batch.get("vision"),
                         compute_dtype=compute_dtype, device=dev)
        return M.prefill(params, tokens, cfg, ctx)

    return prefill_step


def make_serve_step(cfg: ArchConfig, buffer_len: int, *,
                    compute_dtype=torch.bfloat16, device="cuda"):
    """One new token against a KV cache of ``buffer_len`` (and the recurrent
    states, or the VLM's vision K/V). The step updates ``states`` in place
    and returns it; next_tok is (B,), or (B, K) with codebooks."""
    dev = resolve_device(device)

    @torch.no_grad()
    def serve_step(params, states, batch):
        tokens = batch["tokens"].to(dev)          # (B, 1[, K])
        cache_len = batch["cache_len"].to(dev)    # (B,) current filled length
        ctx = M.make_ctx(cfg, buffer_len, "decode", vision=batch.get("vision"),
                         cache_len=cache_len, compute_dtype=compute_dtype,
                         device=dev)
        logits, states = M.decode_step(params, tokens, states, cache_len,
                                       cfg, ctx)
        next_tok = logits[:, -1].argmax(-1)       # ties go to the first index
        return logits, states, next_tok

    return serve_step


def greedy_generate(cfg: ArchConfig, params, prompt, max_new: int, *,
                    vision=None, compute_dtype=torch.bfloat16, device="cuda"):
    """Reference autoregressive loop: feed the prompt (B, S), or (B, S, K)
    with codebooks, token by token through the decode path, then generate
    ``max_new`` tokens. The cache has the compute dtype (bf16 by default,
    as in the reference); the VLM's vision K/V are built once from params
    and ``vision``."""
    dev = resolve_device(device)
    b = prompt.shape[0]
    buf = prompt.shape[1] + max_new
    if vision is not None:
        vision = torch.as_tensor(vision, device=dev)   # moved once
    states = T.init_decode_state(cfg, b, buf, dtype=compute_dtype, device=dev,
                                 vision=vision, params=params)
    step = make_serve_step(cfg, buf, compute_dtype=compute_dtype, device=dev)
    prompt = prompt.to(dev)
    cache_len = torch.zeros((b,), dtype=torch.int32, device=dev)
    out = []
    cur = prompt[:, :1]
    for i in range(buf - 1):
        batch = {"tokens": cur, "cache_len": cache_len}
        if vision is not None:
            batch["vision"] = vision
        _, states, nxt = step(params, states, batch)
        cache_len = cache_len + 1
        if i + 1 < prompt.shape[1]:
            cur = prompt[:, i + 1:i + 2]          # teacher-force the prompt
        else:
            cur = nxt[:, None]                    # (B, 1[, K])
            out.append(cur)
    return torch.cat(out, dim=1) if out else prompt[:, :0]


# ---------------------------------------------------------------------------
# the sharded steps (the reference's dryrun.build_cell, prefill and decode)
# ---------------------------------------------------------------------------

LAYOUTS = ("fsdp", "resident")


def _check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"unknown serving layout {layout!r}; one of "
                         f"{LAYOUTS}")


def _batch_entry(states):
    """The batch dim's spec entry of a sharded decode state, read from its
    DTensors' placements: dim -4 of its first leaf in every layout (a KV
    cache (..., B, S, KV, D), the wkv state (..., B, H, K, V) or the SSM
    state (..., B, H, N, P))."""
    from repro_torch.sharding import spmd as S
    return S.spec_of(states["layers" if "layers" in states
                            else "inner"][0])[-4]


def _step_ctx(mesh, rules, pspecs, params, rows: int, layout: str = "fsdp"):
    """(MeshCtx, this rank's param shards) for a call of ``rows`` global
    rows; the model gathers each FSDP-sharded layer where it runs."""
    from repro_torch.sharding import spmd as S
    from repro_torch.sharding.rules import batch_axis, set_rules
    set_rules(rules)
    mc = S.MeshCtx(mesh, batch_axis(rules, rows, layout) is not None,
                   fsdp=pspecs)
    return mc, S.to_local(params)


def _global_rows(x, mc):
    """This rank's rows -> the global batch's, gathered over the batch
    shards."""
    from repro_torch.sharding import spmd as S
    return S.all_gather(x, mc.batch_group, 0) if mc.shards_batch else x


def _vision_rows(batch, mc, dev):
    """This rank's rows of the batch's vision states, or None."""
    from repro_torch.sharding import spmd as S
    vision = batch.get("vision")
    return None if vision is None else S.dp_rows(
        torch.as_tensor(vision, device=dev), mc)


def make_sharded_prefill_step(cfg: ArchConfig, mesh, *,
                              compute_dtype=torch.bfloat16, device="cuda"):
    """prefill_step(params, batch) -> last-position logits (B, V), or
    (B, K, V) with codebooks, of the global batch, on every rank; params:
    DTensors under the param specs of ``train_step.sharded_specs``; batch:
    the global batch's tokens (B, S[, K]) and the VLM's vision states
    (B, Nv, d_src), the same on every rank."""
    from repro_torch.sharding import spmd as S
    from repro_torch.train.train_step import sharded_specs
    dev = resolve_device(device)
    rules, pspecs, _ = sharded_specs(cfg, mesh)

    @torch.no_grad()
    def prefill_step(params, batch):
        tokens = batch["tokens"].to(dev)
        mc, local = _step_ctx(mesh, rules, pspecs, params, tokens.shape[0])
        ctx = M.make_ctx(cfg, tokens.shape[1], "prefill",
                         vision=_vision_rows(batch, mc, dev),
                         compute_dtype=compute_dtype, device=dev, mesh=mc)
        return _global_rows(M.prefill(local, S.dp_rows(tokens, mc), cfg,
                                      ctx), mc)

    return prefill_step


def init_sharded_decode_state(cfg: ArchConfig, mesh, batch: int,
                              buffer_len: int, *, dtype=torch.bfloat16,
                              device="cuda", vision=None, params=None,
                              layout: str = "fsdp"):
    """This rank's decode state, as DTensors under
    ``decode_state_specs(layout=layout)``: batch over the batch shards
    ("pod" x "data") where they divide it (replicated for "resident"); KV
    heads over model where it divides them, else the KV sequence over
    model (and over the batch axes too where the batch is not sharded);
    the RWKV wkv state's and the Mamba SSM state's heads and
    the conv state's channels over model, the last-token rows whole. Zeros,
    but for the VLM's vision K/V, built as on one device from ``vision``
    (B, Nv, d_src), this rank's rows of it, and ``params`` (DTensors under
    ``sharded_specs``' param specs of the layout): each rank's wk and wv
    columns, gathered to every kv head, which the state keeps whole."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.sharding import rules as SR
    from repro_torch.sharding import spmd as S
    from repro_torch.train.train_step import sharded_specs
    _check_layout(layout)
    dev = resolve_device(device)
    rules = SR.AxisRules.for_mesh(mesh)
    specs = SR.decode_state_specs(cfg, batch, rules, layout=layout)
    vlm = cfg.family == "vlm"
    if vlm and (vision is None or params is None):
        raise ValueError(f"{cfg.name}: the decode state needs vision and "
                         "params for its cross-attention layers")
    with FakeTensorMode():
        kw = {} if not vlm else {
            "vision": torch.empty(batch, cfg.n_vision_tokens,
                                  cfg.vision_dim),
            "params": M.init_params(cfg, 0, device="cpu")}
        shapes = T.init_decode_state(cfg, batch, buffer_len, dtype=dtype,
                                     **kw)

    def zeros(shape_of, spec):
        local = torch.zeros(S.local_shape(shape_of.shape, spec, mesh),
                            dtype=shape_of.dtype, device=dev)
        return S.from_local(local, spec, mesh, shape_of.shape)

    if not vlm:
        return S.map_tree(zeros, shapes, specs)
    states = {k: S.map_tree(zeros, shapes[k], specs[k])
              for k in ("inner", "trailing")}
    _, pspecs, _ = sharded_specs(cfg, mesh, fsdp=layout == "fsdp")
    mc, local = _step_ctx(mesh, rules, pspecs, params, batch, layout)
    with torch.no_grad():
        kv = T.cross_state(cfg, local, _vision_rows({"vision": vision}, mc,
                                                    dev), dtype, mesh=mc)
    states["single"] = tuple(S.from_local(t, spec, mesh, shape.shape)
                             for t, spec, shape in zip(kv, specs["single"],
                                                       shapes["single"]))
    return states


def reset_sharded_slot(states, s: int, mesh, batch: int) -> None:
    """``transformer.reset_slot`` of global slot ``s`` on this rank's local
    states (``init_sharded_decode_state``'s, of ``batch`` slots), where
    this rank holds it: every rank of the slot's batch shard, at the
    slot's local row; every rank where the state replicates the batch
    ("resident", or a batch that the batch shards do not divide)."""
    from repro_torch.sharding import spmd as S
    mc = S.MeshCtx(mesh, _batch_entry(states) is not None)
    row = S.dp_row(s, batch, mc)
    if row is not None:
        T.reset_slot(S.to_local(states), row)


def make_sharded_serve_step(cfg: ArchConfig, mesh, buffer_len: int, *,
                            compute_dtype=torch.bfloat16, device="cuda",
                            layout: str = "fsdp"):
    """The serve step on every rank of ``mesh``: ``init_sharded_decode_state``'s
    state of the same ``layout`` (updated in place), batch the global
    batch's tokens (B, 1[, K]) and cache_len (B,) (and the VLM's vision,
    which decode does not read: its K/V are the state's); returns the
    global batch's logits (B, 1[, K], V), the state, and next_tok (B[, K]),
    the same on every rank. ``layout``: "fsdp" (params under the FSDP
    specs, each layer gathered over data where it runs, the batch over
    the batch shards where they divide it) or "resident" (the reference's
    serving layout,
    ``dryrun.build_cell``'s ``serve_layout``: params under
    ``sharded_specs(fsdp=False)``, model-axis TP only, which the caller
    casts to bf16; the batch replicated). The step reads the state's
    layout from its DTensors' placements: the batch's entry, which must be
    the one ``layout`` gives, and the KV caches' sequence entry; it builds
    the ``MeshCtx`` of each such layout and row count once."""
    from repro_torch.sharding import spmd as S
    from repro_torch.sharding.rules import batch_axis, set_rules
    from repro_torch.train.train_step import sharded_specs
    _check_layout(layout)
    dev = resolve_device(device)
    rules, pspecs, _ = sharded_specs(cfg, mesh, fsdp=layout == "fsdp")
    keys = T.kv_cache_keys(cfg)
    ctxs = {}

    def step_ctx(rows, states):
        b_ax = _batch_entry(states)
        kv_seq = S.spec_of(states[keys[0]][0])[-3] if keys else None
        if (rows, b_ax, kv_seq) not in ctxs:
            if b_ax != batch_axis(rules, rows, layout):
                raise ValueError(
                    f"a decode state whose batch spec entry is {b_ax!r} for "
                    f"a {layout!r} serve step of {rows} rows: build it with "
                    f"init_sharded_decode_state(..., layout={layout!r})")
            ctxs[rows, b_ax, kv_seq] = S.MeshCtx(mesh, b_ax is not None,
                                                 kv_seq=kv_seq, fsdp=pspecs)
        return ctxs[rows, b_ax, kv_seq]

    @torch.no_grad()
    def serve_step(params, states, batch):
        tokens = batch["tokens"].to(dev)
        mc = step_ctx(tokens.shape[0], states)
        set_rules(rules)
        local = S.to_local(params)
        cache_len = S.dp_rows(batch["cache_len"].to(dev), mc)
        ctx = M.make_ctx(cfg, buffer_len, "decode",
                         vision=_vision_rows(batch, mc, dev),
                         cache_len=cache_len, compute_dtype=compute_dtype,
                         device=dev, mesh=mc)
        logits, _ = M.decode_step(local, S.dp_rows(tokens, mc),
                                  S.to_local(states), cache_len, cfg, ctx)
        logits = _global_rows(logits, mc)
        return logits, states, logits[:, -1].argmax(-1)

    return serve_step
