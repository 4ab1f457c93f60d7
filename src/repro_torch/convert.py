"""Weight bridge between the JAX package's param pytrees and the port's.

Both sides are nested dicts with the same keys; stacked layer leaves keep
their leading ``n_layers`` dim. On the JAX side leaves arrive as numpy
arrays (``jax.tree.map(np.asarray, params)``), so this module needs no JAX.
``flatten`` gives the ``/``-joined key paths of the reference's checkpoint
format (``repro/train/checkpoints.py``'s ``_flatten``: dict keys in sorted
order). The round trip is bit-exact; OLMo's zero-size ``{"_np": (0,)}``
non-parametric norm sentinel goes through like any other leaf.

The optimizer state (``repro/train/optimizer.py``'s ``init_opt_state`` and
``train_step.make_opt_state``) crosses the same way: ``mu``, ``nu`` and,
where present, ``master`` and ``residuals`` are fp32 trees shaped like the
params, ``step`` a 0-d int32.
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


OPT_TREES = ("mu", "nu", "master", "residuals")


def opt_state_from_numpy(state, device="cpu") -> dict:
    """numpy optimizer state -> tensors on ``device``."""
    extra = set(state) - set(OPT_TREES) - {"step"}
    if extra:
        raise KeyError(f"unknown optimizer state entries {sorted(extra)}")
    step = np.asarray(state["step"])
    if step.dtype != np.int32 or step.shape != ():
        raise TypeError(f"expected a 0-d int32 step, got {step.dtype} "
                        f"{step.shape}")
    out = {k: from_numpy(state[k], device) for k in OPT_TREES if k in state}
    out["step"] = torch.from_numpy(step.copy()).to(device)
    return out


def opt_state_to_numpy(state) -> dict:
    """tensor optimizer state -> numpy (fp32 trees, 0-d int32 step)."""
    step = state["step"]
    if step.dtype != torch.int32 or step.dim():
        raise TypeError(f"expected a 0-d int32 step, got {step.dtype} "
                        f"{tuple(step.shape)}")
    out = {k: to_numpy(state[k]) for k in OPT_TREES if k in state}
    out["step"] = step.detach().cpu().numpy().copy()
    return out
