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

``make_sharded_train_step`` is the step that the reference's
``build_sharded_train`` jits with shardings, run on a ``DeviceMesh`` by
one process per rank: params under ``param_specs(fsdp=True)`` and AdamW's
moments under ``opt_state_specs`` (ZeRO-1), both as DTensors.
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


def make_loss_fn(cfg: ArchConfig, tcfg: TrainConfig, *, device="cuda",
                 mesh=None):
    """loss_fn(params, batch) -> (loss, metrics) in train mode; batch holds
    tensors on ``device``: tokens and labels, and the VLM's vision. On a
    mesh (a ``spmd.MeshCtx``) params are this rank's shards, batch its
    rows, and the loss this rank's share (``model.loss_fn``)."""
    cd = torch.bfloat16 if tcfg.compute_dtype == "bfloat16" else torch.float32
    dev = resolve_device(device)

    def loss_fn(params, batch):
        if tcfg.param_stream_dtype == "bfloat16":
            params = tree_map(lambda p: p.to(torch.bfloat16)
                              if p.dtype == torch.float32 else p, params)
        ctx = M.make_ctx(cfg, batch["tokens"].shape[1], "train",
                         attn_impl=tcfg.attn_impl, remat=tcfg.remat,
                         vision=batch.get("vision"), compute_dtype=cd,
                         device=dev, mesh=mesh)
        return M.loss_fn(params, batch, cfg, ctx)

    return loss_fn


def _mean_over(value_and_grad, params, blocks):
    """(loss, metrics, grads) over the microbatches ``blocks``: the mean of
    their losses and of their gradients (each a microbatch's mean, not a
    token-weighted mean), summed in fp32, and the last block's metrics, as
    the reference's scan over microbatches gives them; one block's as they
    come."""
    if len(blocks) == 1:
        return value_and_grad(params, blocks[0])
    loss, grads = 0.0, None
    for mb in blocks:
        mb_loss, metrics, mb_grads = value_and_grad(params, mb)
        loss = loss + mb_loss
        if grads is None:
            grads = [g.float() for g in mb_grads]
        else:
            for j, g in enumerate(mb_grads):
                grads[j] = grads[j] + g.float()
        del mb_grads
    k = len(blocks)
    return loss / k, metrics, [g / k for g in grads]


def _row_blocks(batch, k: int):
    """Every entry of ``batch`` (vision included) split into k equal row
    blocks, in order: block j is rows [j B / k, (j + 1) B / k)."""
    rows = batch["tokens"].shape[0]
    if rows % k:
        raise ValueError(f"batch of {rows} rows does not split into {k} "
                         "microbatches")
    return [{n: a[j * rows // k:(j + 1) * rows // k]
             for n, a in batch.items()} for j in range(k)]


def _value_and_grad(cfg: ArchConfig, tcfg: TrainConfig, *, device, mesh):
    """value_and_grad(params, batch) -> (loss, metrics, grads), grads a
    list in ``leaves(params)`` order, of one batch (no microbatches)."""
    loss_fn = make_loss_fn(cfg, tcfg, device=device, mesh=mesh)
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

    return value_and_grad


def make_grad_fn(cfg: ArchConfig, tcfg: TrainConfig, *, device="cuda"):
    """grad_fn(params, batch) -> (loss, metrics, grads), grads shaped like
    params. With ``microbatches`` k > 1 the batch (every entry, vision
    included) is split into k equal row blocks: loss and grads are the
    mean of the per-microbatch means (not a token-weighted mean), summed in
    fp32, and the metrics are the last microbatch's, as in the
    reference."""
    value_and_grad = _value_and_grad(cfg, tcfg, device=device, mesh=None)

    def grad_fn(params, batch):
        loss, metrics, grads = _mean_over(
            value_and_grad, params,
            _row_blocks(batch, max(tcfg.microbatches, 1)))
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


# ---------------------------------------------------------------------------
# the sharded step (the reference's build_sharded_train)
# ---------------------------------------------------------------------------

def sharded_specs(cfg: ArchConfig, mesh, *, fsdp: bool = True):
    """(rules, param specs, opt-state specs) on ``mesh``, as the
    reference's ``build_sharded_train`` and ``dryrun.build_cell`` derive
    them; the prefill and serve steps take the same param specs."""
    from repro_torch.sharding import rules as SR
    from repro_torch.train.optimizer import opt_state_specs
    rules = SR.AxisRules.for_mesh(mesh)
    shapes = M.param_shapes(cfg)
    pspecs = SR.param_specs(cfg, rules, fsdp=fsdp, param_shapes=shapes)
    return rules, pspecs, opt_state_specs(pspecs, shapes, rules)


def shard_train_state(params, tcfg: TrainConfig, pspecs, ospecs, mesh):
    """Full params (the same on every rank, e.g. one seed) -> (params,
    opt_state) of this rank: params as DTensors under ``pspecs``, the
    moments (and masters) zeros of this rank's shape under ``ospecs``
    (the residuals under ``pspecs``), ``step`` a plain 0-d int32."""
    from repro_torch.sharding import spmd as S
    dparams = S.distribute(params, pspecs, mesh)

    def zeros(p, spec):
        local = torch.zeros(S.local_shape(p.shape, spec, mesh),
                            dtype=torch.float32, device=p.device)
        return S.from_local(local, spec, mesh, p.shape)

    state = {"mu": tree_map(zeros, params, ospecs["mu"]),
             "nu": tree_map(zeros, params, ospecs["nu"]),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=leaves(params)[0].device)}
    if tcfg.master_weights:
        state["master"] = S.distribute(
            tree_map(lambda p: p.float(), params), ospecs["mu"], mesh)
    if tcfg.grad_compression:
        state["residuals"] = tree_map(zeros, params, pspecs)
    return dparams, state


def make_sharded_grad_fn(cfg: ArchConfig, tcfg: TrainConfig, mesh, *,
                         device="cuda", specs=None):
    """grad_fn(params, batch) -> (metrics, grads, mc) on every rank of
    ``mesh`` (axes "pod", "data", "model", any of them): the loss and
    gradients of this rank's batch rows through the tensor-parallel
    blocks, from this rank's shards, each FSDP-sharded leaf gathered over
    data one layer at a time where the model reads it and its gradient
    reduce-scattered back (``spmd.gather_params``); then each gradient
    summed over the batch shards into its param's layout
    (``spmd.reduce_grads``: over "pod", and over "data" where data does
    not shard the leaf). With ``microbatches`` k the global batch is split
    as the reference splits it: block j is its rows [j B / k, (j + 1) B /
    k), of which this rank takes its share as of a global batch of B / k
    rows (``batch_axis(rules, B // k)``); loss and gradients are the mean
    over the k blocks, accumulated in fp32 on this rank's shards, and the
    metrics the last block's, over its global rows. params: DTensors under
    ``param_specs(fsdp=True)``; grads: this rank's shards, shaped like the
    params' local tensors; batch: the global batch (every rank the same).
    ``specs``: ``sharded_specs(cfg, mesh)``, derived here when not
    given."""
    from repro_torch.sharding import spmd as S
    from repro_torch.sharding.rules import batch_axis, set_rules

    dev = resolve_device(device)
    rules, pspecs, _ = specs or sharded_specs(cfg, mesh)
    k = max(tcfg.microbatches, 1)

    def grad_fn(params, batch):
        set_rules(rules)
        batch = {n: torch.as_tensor(v, device=dev) for n, v in batch.items()}
        blocks = _row_blocks(batch, k)
        mc = S.MeshCtx(mesh, batch_axis(rules, blocks[0]["tokens"].shape[0])
                       is not None, fsdp=pspecs)
        local = S.to_local(params)
        _, metrics, grads = _mean_over(
            _value_and_grad(cfg, tcfg, device=dev, mesh=mc), local,
            [{n: S.dp_rows(a, mc) for n, a in mb.items()} for mb in blocks])
        it = iter(grads)
        grads = tree_map(lambda _: next(it), local)
        return metrics, S.map_tree(lambda g, s: S.reduce_grads(g, s, mc),
                                   grads, pspecs), mc

    return grad_fn


def make_sharded_train_step(cfg: ArchConfig, tcfg: TrainConfig,
                            ocfg: OptimizerConfig, mesh, *, device="cuda",
                            specs=None):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) on every rank of ``mesh`` (a ``DeviceMesh`` over "pod",
    "data" and "model", any of them), with the state of
    ``shard_train_state``, updated in place:
    ``make_sharded_grad_fn``'s gradients (then, with
    ``grad_compression``, compressed with feedback on this rank's shards),
    the global grad norm over every rank's shards, and AdamW on this rank's
    shard of each moment (ZeRO-1 over "data" alone, as the reference's
    ``opt_state_specs``: a param that is whole over data where its moment
    is data-sharded is updated in this rank's slice and gathered back over
    data; "pod" replicates both, and every pod updates alike). The metrics
    are the global batch's, the same on every rank.
    ``specs``: ``sharded_specs(cfg, mesh)``, derived here when not
    given."""
    import torch.distributed as dist

    from repro_torch.sharding import spmd as S

    specs = specs or sharded_specs(cfg, mesh)
    _, pspecs, ospecs = specs
    grad_fn = make_sharded_grad_fn(cfg, tcfg, mesh, device=device,
                                   specs=specs)

    def zero_dim(pspec, mspec):
        """The dim a moment shards over data where its param does not."""
        return next((i for i, (p, m) in enumerate(zip(pspec, mspec))
                     if m == "data" and p != "data"), None)

    def train_step(params, opt_state, batch):
        metrics, grads, mc = grad_fn(params, batch)
        if tcfg.grad_compression:     # on this rank's shards, in place
            res = S.to_local(opt_state["residuals"])
            grads, new_res = C.compress_grads_with_feedback(
                grads, res, tcfg.grad_compression)
            with torch.no_grad():
                tree_map(lambda r, n: r.copy_(n), res, new_res)
        sq = sum(g.float().square().sum() / S.replication(s, mesh)
                 for g, s in zip(leaves(grads), leaves(pspecs)))
        gnorm = torch.sqrt(S.all_reduce(sq, dist.group.WORLD))

        # AdamW in each moment's layout: a param that is whole over data
        # where its moment is data-sharded takes this rank's slice (a view)
        plocal = S.to_local(params)
        cuts = S.map_tree(lambda p, ps, ms: zero_dim(ps, ms)
                          if mc.dp > 1 else None,
                          plocal, pspecs, ospecs["mu"])

        def part(t, i):
            return t if i is None else t.chunk(mc.dp, i)[mc.dp_rank]

        upd = S.map_tree(part, plocal, cuts)
        local_state = {k: S.to_local(opt_state[k])
                       for k in ("mu", "nu", "master") if k in opt_state}
        local_state["step"] = opt_state["step"]
        _, local_state, opt_metrics = adamw_update(
            ocfg, upd, S.map_tree(part, grads, cuts), local_state,
            grad_norm=gnorm)
        opt_state["step"] = local_state["step"]
        with torch.no_grad():
            for whole, mine, i in zip(leaves(plocal), leaves(upd),
                                      leaves(cuts)):
                if i is not None:
                    whole.copy_(S.all_gather(mine, mc.data_group, i))
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step
