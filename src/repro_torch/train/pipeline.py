"""Pipeline parallelism: the GPipe schedule over a stage group (the port of
``repro/train/pipeline.py``).

Each rank of the stage group holds one contiguous block of layers, and
microbatch activations flow stage to stage by ``send``/``recv``: with S
stages and M microbatches there are T = M + S - 1 ticks, stage s computes
microbatch t - s at tick t, and activations hop one stage a tick (bubble
fraction (S - 1) / T). The last stage's outputs reach every rank (the
reference's masked ``psum`` over the stages). ``sequential_apply`` is the
oracle.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.sharding import spmd as S


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def pipeline_apply(stage_fn: Callable, stage_params, x, *, group,
                   n_microbatches: int):
    """Run x through the group's S pipelined stages.

    stage_fn(params, activation) -> activation of the same shape;
    stage_params: this stage's params with a leading dim of 1 (its shard of
    the stage-stacked tree, as the reference's ``P(axis)``); x: (batch, ...)
    on every rank, batch % n_microbatches == 0. Returns stage_fn applied S
    times, (batch, ...), on every rank."""
    s, sid = dist.get_world_size(group), dist.get_rank(group)
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} does not split into {n_microbatches} "
                         "microbatches")
    micro = x.reshape((n_microbatches, b // n_microbatches) + x.shape[1:])
    params = _index(stage_params, 0)
    outs = torch.zeros_like(micro)
    buf = torch.zeros_like(micro[0])
    for t in range(n_microbatches + s - 1):
        cur = micro[min(t, n_microbatches - 1)] if sid == 0 else buf
        mb = t - sid                        # the microbatch at this stage
        y = stage_fn(params, cur) if 0 <= mb < n_microbatches else cur
        if sid == s - 1 and mb >= 0:
            outs[mb] = y                    # the last stage commits
        # hop: stage i -> i + 1
        buf = S.exchange(y if sid < s - 1 else None,
                         sid + 1 if sid < s - 1 else None,
                         buf if sid > 0 else None,
                         sid - 1 if sid > 0 else None, group)
        if buf is None:
            buf = cur
    outs = S.broadcast(outs, s - 1, group)
    return outs.reshape((b,) + outs.shape[2:])


def sequential_apply(stage_fn: Callable, stage_params, x):
    """Reference: the same stages applied serially (oracle for tests).
    stage_params: stacked on a leading S dim."""
    n = next(iter(_leaves(stage_params))).shape[0]
    for i in range(n):
        x = stage_fn(_index(stage_params, i), x)
    return x


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
