"""Gradient compression with error feedback (the port of
``repro/train/compression.py``): bf16, or int8 with one symmetric scale per
tensor, so that the optimizer sees what a compressed all-reduce would
deliver, with the quantization error carried into the next step; and
``compressed_psum``, the low-precision all-reduce itself over a process
group (the reference's ``shard_map`` building block).
"""
from __future__ import annotations

from typing import Literal

import torch

from repro_torch.train.optimizer import tree_map


def compress(g, kind: Literal["bf16", "int8"] = "bf16"):
    """Returns (q, scale): bf16 values and no scale, or int8 values of
    round(g / scale) (half to even, as ``jnp.round``) clipped to ±127 with
    scale max|g| / 127, floored at 1e-12 / 127."""
    if kind == "bf16" or g.numel() == 0:
        return g.to(torch.bfloat16), None
    scale = g.abs().max().clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q, scale, dtype=torch.float32):
    if scale is None:
        return q.to(dtype)
    return q.to(dtype) * scale


def compress_grads_with_feedback(grads, residuals, kind="bf16"):
    """Returns (compressed-then-decompressed grads, new residuals), both
    fp32: residual_{t+1} = g + residual_t - Q(g + residual_t)."""
    out = tree_map(lambda g, r: _one(g, r, kind), grads, residuals)
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)


def _one(g, r, kind):
    g32 = g.float() + r
    deq = decompress(*compress(g32, kind))
    return deq, g32 - deq


def init_residuals(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def compressed_psum(x, group, kind: Literal["bf16", "int8"] = "bf16"):
    """All-reduce in low precision over ``group``: quantize locally,
    all-gather the compressed values (and the int8 scales), dequantize
    and sum in fp32, in group rank order. Halves (bf16) or quarters (int8)
    the bytes on the wire against an fp32 all-reduce; every rank gets the
    same sum."""
    from repro_torch.sharding import spmd as S
    q, scale = compress(x, kind)
    qs = S.all_gather(q[None], group, 0)              # (n, ...) compressed
    if scale is not None:
        scales = S.all_gather(scale.reshape(1), group, 0)
        parts = [qs[r].float() * scales[r] for r in range(qs.shape[0])]
    else:
        parts = [qs[r].float() for r in range(qs.shape[0])]
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out
