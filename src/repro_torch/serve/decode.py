"""Serving steps (the port of ``repro/serve/decode.py``): prefill and
one-token decode.

There is no ``attn_impl`` switch: on CUDA tensors prefill runs the flash,
WKV6 and SSD kernels and decode attention the decode kernel (the RWKV and
Mamba decode steps and cross-attention are plain torch, as in the
reference); their plain versions serve CPU tensors only.
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
