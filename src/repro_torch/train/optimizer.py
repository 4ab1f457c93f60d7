"""AdamW with global-norm clipping and a cosine schedule (the port of
``repro/train/optimizer.py``).

The optimizer state is a dict shaped like the params: ``mu`` and ``nu``
(fp32), ``step`` (a 0-d int32 tensor) and, with master weights, ``master``
(the fp32 truth of bf16 params). ``adamw_update`` updates params and state
in place, under ``torch.no_grad()``, with the values the reference's
functional update returns; in place, a full-width step needs no second
copy of the params and moments. ``opt_state_specs`` gives the state's
ZeRO-1 layout on a mesh: the moments take one more dim over the data axis
where a dim divides.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: OptimizerConfig, step):
    """Linear warmup to ``lr`` over ``warmup_steps``, then a cosine down to
    ``min_lr_frac * lr`` at ``total_steps``. step: a tensor; fp32 math."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def tree_map(fn, *trees):
    """fn over the leaves of nested dicts of one structure."""
    return {k: tree_map(fn, *(t[k] for t in trees)) if isinstance(v, dict)
            else fn(*(t[k] for t in trees)) for k, v in trees[0].items()}


def leaves(tree) -> list:
    """The leaves of a nested dict, keys in insertion order."""
    out = []
    for v in tree.values():
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


def init_opt_state(params, master_weights: bool = False):
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    state = {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=leaves(params)[0].device)}
    if master_weights:
        # params live in bf16; the fp32 truth lives here
        state["master"] = tree_map(lambda p: p.float().clone(), params)
    return state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.sqrt(torch.stack(
        [g.float().square().sum() for g in leaves(tree)]).sum())


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params, grads, opt_state,
                 grad_norm=None):
    """One AdamW step with decoupled weight decay on leaves of two or more
    dims (the stacked per-layer norm scales and qk-norms are (L, ·), so
    they are decayed, and ``final_norm`` is not, as in the reference).
    Updates ``params`` and ``opt_state`` in place and returns them with
    {"grad_norm" (before clipping), "lr"}. With a "master" entry the update
    is computed on the fp32 masters and params get their cast. A sharded
    step passes the global ``grad_norm`` of every rank's shards, since
    its ``grads`` are this rank's shards."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / gnorm.clamp_min(1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.betas
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    masters = opt_state.get("master")
    base = masters if masters is not None else params

    def upd(p, g, mu, nu, out):
        g = g.float() * scale
        mu.copy_(b1 * mu + (1 - b1) * g)
        nu.copy_(b2 * nu + (1 - b2) * g.square())
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if p.dim() >= 2:                      # decoupled WD on matrices only
            delta = delta + cfg.weight_decay * p.float()
        new32 = p.float() - lr * delta
        p.copy_(new32)
        if out is not p:                      # bf16 params of fp32 masters
            out.copy_(new32)

    tree_map(upd, base, grads, opt_state["mu"], opt_state["nu"], params)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# ZeRO-1 sharding of the optimizer state
# ---------------------------------------------------------------------------

def opt_state_specs(param_specs, param_shapes, rules=None,
                    zero: bool = True):
    """Opt-state specs (the reference's). With ``zero`` and a "data" axis in
    the rules, the moments get one more dim sharded over data (ZeRO-1): the
    first unsharded dim that divides, unless the param is already
    data-sharded (FSDP)."""
    from repro_torch.sharding.rules import _shape, current_rules
    rules = rules or current_rules()
    zero_axes = rules.table.get("zero", ()) if (rules and zero) else ()
    zero_size = rules.size(zero_axes[0]) if (rules and zero_axes) else 1

    def one(spec, shape):
        if not zero_axes or zero_size <= 1 or shape is None:
            return spec
        shape = _shape(shape)
        flat_axes = []
        for entry in spec:
            flat_axes.extend(entry if isinstance(entry, tuple) else [entry])
        if zero_axes[0] in flat_axes:      # FSDP params: already data-sharded
            return spec
        parts = list(spec) + [None] * (len(shape) - len(spec))
        for i, (ax, dim) in enumerate(zip(parts, shape)):
            if ax is None and dim % zero_size == 0 and dim >= zero_size:
                parts[i] = zero_axes[0]
                return tuple(parts)
        return spec

    moment_specs = tree_map(one, param_specs, param_shapes)
    return {"mu": moment_specs, "nu": moment_specs, "step": ()}
