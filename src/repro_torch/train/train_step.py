"""Train step (the port of ``repro/train/train_step.py``): loss -> grads
through ``torch.autograd`` (optionally over microbatches) -> gradient
compression with error feedback -> AdamW.

Train mode's attention is the reference's XLA attention in plain PyTorch
(``blocks.train_attention``) and its recurrences are the reference's
chunked scans (``rwkv.wkv6_chunked``, ``mamba.ssd_chunked``); no kernel is
on this path, since no kernel has a backward. Every parameter must come out
of the backward with a gradient: a ``None`` raises, so a graph cut (a
kernel's output has no ``grad_fn``) cannot pass as a zero gradient. Two
kinds of leaves get zero gradients, as ``jax.grad`` gives: zero-size leaves
(OLMo's non-parametric norm sentinel), which hold no value, and the leaves
of the subtrees the layout never runs (``transformer.unused_subtrees``: the
hybrid's and the VLM's placeholder trailing layer when no layer trails).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import convert, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models import transformer as TF
from repro_torch.train import compression as C
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         init_opt_state, leaves, tree_map)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat: str = "full"              # none | full | dots
    attn_impl: str = "xla"           # xla | xla-bf16-logits (pallas raises)
    grad_compression: Optional[str] = None    # None | bf16 | int8
    compute_dtype: str = "bfloat16"
    # cast fp32 params to bf16 once per step, before the layers; the
    # gradients reach the fp32 params through that cast
    param_stream_dtype: Optional[str] = None   # None | bfloat16
    # params stored in bf16, their fp32 masters in the optimizer state
    master_weights: bool = False


def make_loss_fn(cfg: ArchConfig, tcfg: TrainConfig, *, device="cuda"):
    """loss_fn(params, batch) -> (loss, metrics) in train mode; batch holds
    tensors on ``device``: tokens and labels, and the VLM's vision."""
    cd = torch.bfloat16 if tcfg.compute_dtype == "bfloat16" else torch.float32
    dev = resolve_device(device)

    def loss_fn(params, batch):
        if tcfg.param_stream_dtype == "bfloat16":
            params = tree_map(lambda p: p.to(torch.bfloat16)
                              if p.dtype == torch.float32 else p, params)
        ctx = M.make_ctx(cfg, batch["tokens"].shape[1], "train",
                         attn_impl=tcfg.attn_impl, remat=tcfg.remat,
                         vision=batch.get("vision"), compute_dtype=cd,
                         device=dev)
        return M.loss_fn(params, batch, cfg, ctx)

    return loss_fn


def make_grad_fn(cfg: ArchConfig, tcfg: TrainConfig, *, device="cuda"):
    """grad_fn(params, batch) -> (loss, metrics, grads), grads shaped like
    params. With ``microbatches`` k > 1 the batch (every entry, vision
    included) is split into k equal row blocks: loss and grads are the
    mean of the per-microbatch means (not a token-weighted mean), summed in
    fp32, and the metrics are the last microbatch's, as in the
    reference."""
    loss_fn = make_loss_fn(cfg, tcfg, device=device)
    unused = tuple(f"{path}/" for path in TF.unused_subtrees(cfg))

    def value_and_grad(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        names = {id(p): name for name, p in convert.flatten(live).items()}
        idle = {id(p) for p in leaves(live)
                if not p.numel() or names[id(p)].startswith(unused)}
        with torch.enable_grad():
            loss, metrics = loss_fn(live, batch)
            wanted = [p for p in leaves(live) if id(p) not in idle]
            grads = iter(torch.autograd.grad(loss, wanted, allow_unused=True))
        out = [torch.zeros_like(p) if id(p) in idle else next(grads)
               for p in leaves(live)]
        missing = [names[id(p)] for p, g in zip(leaves(live), out)
                   if g is None]
        if missing:
            raise RuntimeError(f"no gradient reached {missing}: the graph "
                               "was cut between them and the loss")
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, out

    def grad_fn(params, batch):
        k = tcfg.microbatches
        if k <= 1:
            loss, metrics, grads = value_and_grad(params, batch)
        else:
            rows = batch["tokens"].shape[0]
            if rows % k:
                raise ValueError(f"batch of {rows} rows does not split into "
                                 f"{k} microbatches")
            loss, grads = 0.0, None
            for i in range(k):
                mb = {n: a[i * rows // k:(i + 1) * rows // k]
                      for n, a in batch.items()}
                mb_loss, metrics, mb_grads = value_and_grad(params, mb)
                loss = loss + mb_loss
                if grads is None:
                    grads = [g.float() for g in mb_grads]
                else:
                    for j, g in enumerate(mb_grads):
                        grads[j] = grads[j] + g.float()
                del mb_grads
            loss = loss / k
            grads = [g / k for g in grads]
        it = iter(grads)
        return loss, metrics, tree_map(lambda _: next(it), params)

    return grad_fn


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig,
                    ocfg: OptimizerConfig, *, device="cuda"):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). params and opt_state are updated in place (see
    ``adamw_update``) and returned; batch arrays (numpy or tensors) are
    moved to ``device``. metrics: the last microbatch's "loss",
    "aux_loss" and "ntokens", and "grad_norm" and "lr"."""
    dev = resolve_device(device)
    grad_fn = make_grad_fn(cfg, tcfg, device=dev)

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        _, metrics, grads = grad_fn(params, batch)
        if tcfg.grad_compression:
            grads, opt_state["residuals"] = C.compress_grads_with_feedback(
                grads, opt_state["residuals"], tcfg.grad_compression)
        params, opt_state, opt_metrics = adamw_update(ocfg, params, grads,
                                                      opt_state)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def make_opt_state(params, tcfg: TrainConfig):
    state = init_opt_state(params, master_weights=tcfg.master_weights)
    if tcfg.grad_compression:
        state["residuals"] = C.init_residuals(params)
    return state
