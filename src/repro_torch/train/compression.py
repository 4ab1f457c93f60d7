"""Gradient compression with error feedback (the port of
``repro/train/compression.py``): bf16, or int8 with one symmetric scale per
tensor, so that the optimizer sees what a compressed all-reduce would
deliver, with the quantization error carried into the next step. The
all-reduce itself (``compressed_psum``) waits for the multi-device slice.
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
