"""Weight bridge between the JAX package's param pytrees and the port's.

Both sides are nested dicts with the same keys; stacked layer leaves keep
their leading ``n_layers`` dim. On the JAX side leaves arrive as numpy
arrays (``jax.tree.map(np.asarray, params)``), so this module needs no JAX.
``flatten`` gives the ``/``-joined key paths of the reference's checkpoint
format (``repro/train/checkpoints.py``'s ``_flatten``: dict keys in sorted
order). The round trip is bit-exact; OLMo's zero-size ``{"_np": (0,)}``
non-parametric norm sentinel goes through like any other leaf.
"""
from __future__ import annotations

import numpy as np
import torch


def flatten(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf} over nested dicts, keys in sorted order."""
    flat = {}
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        val = tree[key]
        if isinstance(val, dict):
            flat.update(flatten(val, path))
        else:
            flat[path] = val
    return flat


def from_numpy(tree, device="cpu") -> dict:
    """numpy pytree (float32 leaves, as the reference initialises them) ->
    tensors on ``device``."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype != np.float32:
            raise TypeError(f"expected float32 params, got {a.dtype}")
        return torch.from_numpy(a.copy()).to(device)   # owned, writable
    return {k: from_numpy(v, device) if isinstance(v, dict) else leaf(v)
            for k, v in tree.items()}


def to_numpy(tree) -> dict:
    """tensor pytree -> numpy pytree (float32 leaves), on the host."""
    def leaf(t):
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32 params, got {t.dtype}")
        return t.detach().cpu().numpy().copy()
    return {k: to_numpy(v) if isinstance(v, dict) else leaf(v)
            for k, v in tree.items()}
