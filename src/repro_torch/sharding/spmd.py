"""SPMD on a ``DeviceMesh``: one process per rank, the port's counterpart of
the reference's GSPMD partitioning and ``shard_map``.

- **State.** A param or optimizer leaf under a spec lives as a DTensor:
  global shape, one placement per mesh dim (``placements``: an axis the
  spec names at dim i is ``Shard(i)``, an axis it does not name is
  ``Replicate()``), and this rank's shard as its local tensor
  (``distribute``, ``from_local``, ``full_tensor``).
- **Compute.** The sharded steps take each leaf's local tensor and run the
  model's plain functions on it, with explicit collectives where the
  reference's partitioner inserts them (``MeshCtx``; the Megatron pairs
  ``tp_copy`` / ``tp_reduce``, and gathers with a slicing or a summing
  backward). Every hand-written kernel sees local tensors only, at this
  rank's heads.
- **Collectives** go through ``torch.distributed`` on the mesh's groups.
  On gloo (ranks that share a card) a CUDA tensor goes through host
  memory: gloo's own handling of CUDA tensors differs by collective and
  by build, and on an H100 with torch 2.11 one collective on CUDA tensors
  aborted the process (PERF.md; ``chip_smoke.py``'s probe reports which).
"""
from __future__ import annotations

import contextlib
import sys

import torch
import torch.distributed as dist

from repro_torch.sharding.mesh import axis_names, axis_sizes

# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _staged(t: torch.Tensor, group) -> bool:
    """gloo moves host memory: a CUDA tensor goes through host memory."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum over the group (or ``op``: ``dist.ReduceOp.MAX`` for a row's
    max over vocab shards); a new tensor (t is left as it is)."""
    if _staged(t, group):
        h = t.detach().cpu().contiguous()
        dist.all_reduce(h, op=op, group=group)
        return h.to(t.device)
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along dim, in group rank order."""
    n = dist.get_world_size(group)
    src = t.detach().contiguous()
    if _staged(t, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(t.device)


def reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Sum over the group, then this rank's chunk along dim."""
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {n}")
    x = t.detach().movedim(dim, 0).contiguous()
    if _staged(t, group):
        x = x.cpu()
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    dist.reduce_scatter_tensor(out.view(-1), x.view(-1), group=group)
    return out.to(t.device).movedim(0, dim)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """t of the group's rank ``src`` (a group rank) on every rank."""
    g_src = dist.get_global_rank(group, src)
    buf = t.detach().contiguous()
    if _staged(t, group):
        buf = buf.cpu()
    else:
        buf = buf.clone()
    dist.broadcast(buf, src=g_src, group=group)
    return buf.to(t.device)


def exchange(send: torch.Tensor | None, dst: int | None,
             recv_like: torch.Tensor | None, src: int | None,
             group) -> torch.Tensor | None:
    """Send ``send`` to group rank ``dst`` and receive a tensor shaped like
    ``recv_like`` from group rank ``src`` (either may be None)."""
    like = send if send is not None else recv_like
    staged = like is not None and _staged(like, group)
    ops, buf = [], None
    if send is not None:
        out = send.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, out.cpu() if staged else out,
                              dist.get_global_rank(group, dst), group))
    if recv_like is not None:
        buf = torch.empty_like(recv_like, device="cpu" if staged else None)
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, src), group))
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    return None if buf is None else buf.to(recv_like.device)


# the collective calls of torch.distributed and of its functional
# collectives (DTensor's redistribution) that ``watch_collectives`` wraps,
# where the installed torch has them; not isend and irecv, which
# batch_isend_irecv checks by identity (their tensors show in its P2POps)
_DIST_CALLS = ("all_gather", "all_gather_into_tensor", "all_reduce",
               "reduce_scatter", "reduce_scatter_tensor", "broadcast",
               "all_to_all", "all_to_all_single", "gather", "scatter",
               "send", "recv", "batch_isend_irecv")
_FUNCOL_CALLS = ("all_gather_tensor", "all_gather_tensor_autograd",
                 "all_gather_single", "all_gather_single_autograd",
                 "all_gather_into_tensor_coalesced", "all_reduce",
                 "all_reduce_coalesced", "reduce_scatter_tensor",
                 "reduce_scatter_tensor_autograd", "reduce_scatter_single",
                 "reduce_scatter_single_autograd",
                 "reduce_scatter_tensor_coalesced", "all_to_all_single",
                 "all_to_all_single_autograd", "broadcast")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dist.P2POp):
        yield x.tensor


@contextlib.contextmanager
def watch_collectives():
    """Yields a list that gets, for each collective call while the block
    runs, the bytes of the largest tensor the call reads or writes. It
    wraps the lowest calls that every path takes: ``torch.distributed``'s
    (this module's collectives, gloo's host copies included) and the
    functional collectives of DTensor's own redistribution
    (``DTensor.full_tensor``). Calls inside ``fsdp_gather`` (FSDP's
    gather of a param leaf or a layer's slice of one, which moves the
    params whatever a cache holds) are left out."""
    import torch.distributed._functional_collectives as funcol
    seen, paused, saved = [], [0], []
    me = sys.modules[__name__]

    def wrap(mod, name, fn):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def watched(orig):
        def call(*a, **kw):
            if not paused[0]:
                seen.append(max((t.numel() * t.element_size()
                                 for t in _tensors((a, tuple(kw.values())))),
                                default=0))
            return orig(*a, **kw)
        return call

    def unwatched(orig):
        def call(*a, **kw):
            paused[0] += 1
            try:
                return orig(*a, **kw)
            finally:
                paused[0] -= 1
        return call

    try:
        for mod, names in ((dist, _DIST_CALLS), (funcol, _FUNCOL_CALLS)):
            for name in names:
                if callable(getattr(mod, name, None)):
                    wrap(mod, name, watched(getattr(mod, name)))
        wrap(me, "fsdp_gather", unwatched(me.fsdp_gather))
        yield seen
    finally:
        for mod, name, orig in reversed(saved):
            setattr(mod, name, orig)


# ---------------------------------------------------------------------------
# differentiable collectives (the Megatron pairs)
# ---------------------------------------------------------------------------

class _Copy(torch.autograd.Function):
    """Identity forward; the gradient summed over the group (the input of
    a column-parallel product: each rank's part of dx)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """Sum over the group forward (the output of a row-parallel product);
    identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceScatter(torch.autograd.Function):
    """Sum over the group, then this rank's chunk along dim (the output of
    a row-parallel product that the rank goes on with at its own columns);
    backward: the gradients' chunks gathered along dim."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    """All-gather along dim. Backward: this rank's chunk of the gradient
    when every rank goes on with the same values (``sum_grads`` False: the
    logits, an untied embedding's columns), else the chunk of the gradient
    summed over the group (ranks that read the gathered tensor differently:
    K and V at fewer heads than ranks, the MoE's tokens over data)."""

    @staticmethod
    def forward(ctx, x, group, dim, sum_grads):
        ctx.group, ctx.dim, ctx.sum_grads = group, dim, sum_grads
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grads:
            return reduce_scatter(g, ctx.group, ctx.dim), None, None, None
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, ctx.dim)[r].contiguous(), None, None, None


# ---------------------------------------------------------------------------
# the mesh as one step's model code reads it
# ---------------------------------------------------------------------------

def _groups(mesh) -> dict:
    """{axes: this rank's process group over them} for every set of two or
    more of ``mesh``'s axes of size above 1, made at the mesh's first need
    and kept on it: every rank makes the same groups in the same order
    (``dist.new_group`` is collective over the world), once per mesh, so
    that a step that builds a ``MeshCtx`` a call makes none. Axes that
    cover a mesh laid over the whole world in rank order take the world's
    group. A group's ranks are the ranks that share the other axes'
    coordinates; in group rank order they run over ``axes`` major to minor,
    as ``shard_of`` orders a multi-axis entry's chunks. The mesh's rank
    tensor is host bookkeeping, read with every dispatch mode off (a
    dry-run's step runs under a ``FakeTensorMode`` and a counter)."""
    got = getattr(mesh, "_spmd_groups", None)
    if got is not None:
        return got
    import itertools
    import math

    from torch.utils._python_dispatch import _disable_current_modes
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    wide = [a for a in names if sizes[a] > 1]
    with _disable_current_modes():
        ranks = mesh.mesh
        in_order = ranks.numel() == dist.get_world_size() and \
            ranks.flatten().tolist() == list(range(ranks.numel()))
        combos = [axes for n in range(2, len(wide) + 1)
                  for axes in itertools.combinations(wide, n)]
        rows_of = {}
        for axes in combos:
            dims = [names.index(a) for a in axes]
            rest = [i for i in range(len(names)) if i not in dims]
            rows_of[axes] = ranks.permute(*rest, *dims).reshape(
                -1, math.prod(sizes[a] for a in axes)).tolist()
    me, got = dist.get_rank(), {}
    for axes in combos:
        if len(axes) == len(wide) and in_order:
            got[axes] = dist.group.WORLD
            continue
        for row in rows_of[axes]:
            if row != sorted(row):
                raise ValueError(f"mesh {names} is not laid out in rank "
                                 "order")
            group = dist.new_group(ranks=row)
            if me in row:
                got[axes] = group
    mesh._spmd_groups = got
    return got


def _group_over(mesh, axes: tuple[str, ...]):
    """The process group over ``axes`` of ``mesh`` (each of size above 1):
    the axis's own group for one axis, else ``_groups``'."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return _groups(mesh)[tuple(axes)]


def _coord(mesh, axes) -> int:
    """This rank's index over ``axes`` of ``mesh``, major to minor."""
    sizes, out = axis_sizes(mesh), 0
    for a in axes:
        out = out * sizes[a] + mesh.get_local_rank(a)
    return out


def _data_dims(specs, dp: int):
    """A param spec tree -> the same tree of the dim (negative, so that it
    holds for a layer's slice of a stacked leaf) that the data axis shards,
    or None; None for the whole tree where data shards no leaf."""
    if dp == 1:
        return None
    seen = []

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        dim = next((i - len(tree) for i, entry in enumerate(tree)
                    if "data" in _axes(entry)), None)
        seen.append(dim is not None)
        return dim
    dims = walk(specs)
    return dims if any(seen) else None


class MeshCtx:
    """A ``DeviceMesh`` over "pod", "data" and "model" axes (any of them,
    in that order: ("data", "model"), its 1-D forms, ("pod", "data",
    "model")), as the model code reads it during one step: the groups,
    sizes and coordinates of this rank.

    Two ideas are kept apart, as the reference's rules keep them:

    - **The batch shards**: "pod" x "data", pod major (the logical "batch"
      axis, ``AxisRules.for_mesh``): ``batches`` of them, this rank's
      ``batch_rank`` and their ``batch_group``. ``batch_sharded``: whether
      the step's batch is sharded over them (``batch_specs``: when they
      divide the global batch); ``dp_rows``, ``dp_row`` and ``dp_gather``
      split and gather rows over them.
    - **The FSDP/ZeRO axis**: "data" alone (``dp``, ``dp_rank``,
      ``data_group``). ``fsdp``: the step's param specs; a leaf that data
      shards is gathered whole over data where the model reads it (a
      stacked leaf one layer at a time, ``gather_params``), its gradient
      reduce-scattered back. "pod" replicates the params.

    ``kv_seq``: the sequence entry of the decode state's KV cache spec
    (``decode_state_specs``: "model", "data", ("data", "model"),
    ("pod", "data") or ("pod", "data", "model"), or None). Of its axes,
    those of size above 1 shard the KV sequence (``kv_seq_axes``); the
    step's attention then runs over this rank's shard, ``kv_shard`` (major
    to minor, as ``shard_of`` orders the shards), and merges the ranks'
    partial softmaxes over ``kv_seq_group`` (``merge_partials``)."""

    def __init__(self, mesh, batch_sharded: bool = True, kv_seq=None,
                 fsdp=None):
        names = axis_names(mesh)
        if set(names) - {"pod", "data", "model"}:
            raise ValueError(f"mesh axes {names}: the sharded steps read "
                             "'pod', 'data' and 'model' axes")
        sizes = axis_sizes(mesh)
        self.mesh = mesh
        self.batch_sharded = batch_sharded
        self.tp = sizes.get("model", 1)
        self.dp = sizes.get("data", 1)
        self.pods = sizes.get("pod", 1)
        self.model_group = mesh.get_group("model") if "model" in names \
            else None
        self.data_group = mesh.get_group("data") if "data" in names else None
        self.pod_group = mesh.get_group("pod") if "pod" in names else None
        self.tp_rank = mesh.get_local_rank("model") if "model" in names \
            else 0
        self.dp_rank = mesh.get_local_rank("data") if "data" in names else 0
        batch_axes = tuple(a for a in ("pod", "data") if sizes.get(a, 1) > 1)
        self.batches = self.pods * self.dp
        self.batch_rank = _coord(mesh, batch_axes)
        self.batch_group = _group_over(mesh, batch_axes) if batch_axes \
            else None
        self.kv_seq_axes = tuple(a for a in _axes(kv_seq)
                                 if sizes.get(a, 1) > 1)
        self.kv_shard = _coord(mesh, self.kv_seq_axes)
        self.kv_seq_group = _group_over(mesh, self.kv_seq_axes) \
            if self.kv_seq_axes else None
        self.fsdp = None if fsdp is None else _data_dims(fsdp, self.dp)

    @property
    def shards_batch(self) -> bool:
        """The step's rows are this rank's batch shard of the batch."""
        return self.batch_sharded and self.batches > 1


def tp_copy(x, mc: MeshCtx | None):
    if mc is None or mc.tp == 1:
        return x
    return _Copy.apply(x, mc.model_group)


def tp_reduce(x, mc: MeshCtx | None):
    if mc is None or mc.tp == 1:
        return x
    return _Reduce.apply(x, mc.model_group)


def tp_sum(x, mc: MeshCtx | None):
    """Sum over the model axis, and the gradient summed too: a value that
    every rank reads with only its own part of the output (the gated
    RMSNorm's sum of squares over ``d_inner``, each rank its columns)."""
    if mc is None or mc.tp == 1:
        return x
    return _Copy.apply(_Reduce.apply(x, mc.model_group), mc.model_group)


def tp_reduce_scatter(x, mc: MeshCtx | None, dim: int):
    """A row-parallel product's partial sums -> this rank's chunk of the
    sum along dim."""
    if mc is None or mc.tp == 1:
        return x
    return _ReduceScatter.apply(x, mc.model_group, dim % x.dim())


def tp_cols(x, mc: MeshCtx | None, dim: int = -1):
    """This rank's chunk along dim of a tensor that every rank holds whole
    (a replicated leaf read at the rank's heads or columns). No collective:
    the caller sums the gradient where it must (``tp_copy`` on x)."""
    if mc is None or mc.tp == 1:
        return x
    return x.chunk(mc.tp, dim)[mc.tp_rank]


def tp_gather(x, mc: MeshCtx | None, dim: int, sum_grads: bool = False):
    if mc is None or mc.tp == 1:
        return x
    return _Gather.apply(x, mc.model_group, dim % x.dim(), sum_grads)


def dp_gather(x, mc: MeshCtx | None, dim: int = 0):
    """This rank's rows -> the global batch's (summing backward)."""
    if mc is None or not mc.shards_batch:
        return x
    return _Gather.apply(x, mc.batch_group, dim % x.dim(), True)


def dp_rows(x, mc: MeshCtx | None, dim: int = 0):
    """The global batch's rows -> this rank's batch shard."""
    if mc is None or not mc.shards_batch:
        return x
    return x.chunk(mc.batches, dim)[mc.batch_rank]


def fsdp_gather(x, dim: int, mc: MeshCtx):
    """One FSDP-sharded leaf, or a layer's slice of one, gathered whole
    over data along ``dim``; its gradient reduce-scattered back over data
    (``_Gather`` summing: each data rank reads the whole leaf with its own
    rows)."""
    return _Gather.apply(x, mc.data_group, dim % x.dim(), True)


def gather_params(tree, mc: MeshCtx | None, *path: str, lead: int = 0):
    """``tree`` (a param subtree at ``path`` of the param tree, or a
    layer's slice of one: stacked dims indexed away in front) with each
    leaf that data shards gathered whole over data (``fsdp_gather``), where
    the model reads it: a stacked layer's leaves inside its checkpointed
    function, so that under remat the recompute gathers again and no
    whole layer is kept between the forward and the backward. With
    ``lead`` k, only the leaves that data shards along one of their first
    k dims, the stack dims that the caller indexes next: FSDP may shard
    the periodic layouts' inner layer dim ((P, I, ...): a per-layer vector
    whose own dim the model axis takes), so such a leaf is gathered a
    stack at a time, before its layers are indexed; a layer's slice then
    passes it as it is. The others pass as they are; everything passes off
    a mesh or without FSDP."""
    if mc is None or mc.fsdp is None:
        return tree
    dims = mc.fsdp
    for key in path:
        dims = dims[key]

    def walk(t, d):
        if isinstance(t, dict):
            return {k: walk(v, d[k]) for k, v in t.items()}
        if d is None or d < -t.dim():         # not sharded, or gathered
            return t                          # with its stack already
        if lead and d >= lead - t.dim():      # a dim that stays
            return t
        return fsdp_gather(t, d, mc)
    return walk(tree, dims)


def merge_pieces(pieces):
    """Partial softmaxes over disjoint pieces of one sequence -> the whole
    sequence's (o, lse). ``pieces``: [(o (B, H, D), lse (B, H)), ...] in
    fp32, lse ``-inf`` (and o zeros) where a piece holds no valid position
    of a row. The log-sum-exp merge: the max m of the pieces' lse, weights
    exp(lse - m) (0 for an empty piece, with m taken as 0 where every piece
    is empty, so that no -inf - -inf is taken), o the weighted sum over the
    weights' sum; a row that no piece holds gives zeros and -inf."""
    o = torch.stack([p[0] for p in pieces])              # (n, B, H, D)
    lse = torch.stack([p[1] for p in pieces])            # (n, B, H)
    m = lse.amax(0)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    w = torch.exp(lse - m)
    total = w.sum(0)
    out = (w[..., None] * o).sum(0) / total.clamp_min(1e-37)[..., None]
    return out, m + torch.log(total)


def merge_partials(o, lse, group, dtype=None):
    """This rank's partial softmax o (B, H, D) and lse (B, H), both fp32,
    merged with the other ranks' of ``group`` (``merge_pieces``); the
    merged o cast once to ``dtype`` (o's by default). One gather of
    (B, H, D + 1) floats a rank: the ranks' pieces, never their caches."""
    both = torch.cat([o.float(), lse.float()[..., None]], -1)[None]
    got = all_gather(both, group, 0)                     # (n, B, H, D + 1)
    out, _ = merge_pieces([(g[..., :-1], g[..., -1]) for g in got])
    return out.to(dtype or o.dtype)


def dp_row(s: int, rows: int, mc: MeshCtx | None) -> int | None:
    """Row ``s`` of a global batch of ``rows`` -> its row in this rank's
    batch shard (``dp_rows``' split), or None where another shard holds
    it."""
    if mc is None or not mc.shards_batch:
        return s
    owner, row = divmod(s, rows // mc.batches)
    return row if owner == mc.batch_rank else None


# ---------------------------------------------------------------------------
# specs, placements and sharded state
# ---------------------------------------------------------------------------

def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: tuple, mesh) -> list:
    """A spec's DTensor placements on ``mesh``: ``Shard(i)`` for a mesh axis
    that spec entry i names, ``Replicate()`` for one it does not."""
    from torch.distributed.tensor import Replicate, Shard
    where = {a: i for i, entry in enumerate(spec) for a in _axes(entry)}
    return [Shard(where[a]) if a in where else Replicate()
            for a in axis_names(mesh)]


def spec_of(dt) -> tuple:
    """A DTensor's placements as a spec (one mesh axis a sharded dim)."""
    from torch.distributed.tensor import Shard
    spec = [None] * dt.dim()
    for name, pl in zip(axis_names(dt.device_mesh), dt.placements):
        if isinstance(pl, Shard):
            spec[pl.dim] = name if spec[pl.dim] is None \
                else (*_axes(spec[pl.dim]), name)
    return tuple(spec)


def local_shape(shape, spec: tuple, mesh) -> tuple[int, ...]:
    sizes = axis_sizes(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        for a in _axes(entry):
            if out[i] % sizes[a]:
                raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                                 f"over {a} ({sizes[a]})")
            out[i] //= sizes[a]
    return tuple(out)


def shard_of(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's shard of a full tensor under ``spec`` (a copy)."""
    sizes = axis_sizes(mesh)
    local_shape(full.shape, spec, mesh)                 # checks the split
    x = full
    for i, entry in enumerate(spec):
        idx, n = 0, 1
        for a in _axes(entry):                          # major to minor
            idx = idx * sizes[a] + mesh.get_local_rank(a)
            n *= sizes[a]
        if n > 1:
            x = x.chunk(n, i)[idx]
    return x.clone(memory_format=torch.contiguous_format)


def from_local(local: torch.Tensor, spec: tuple, mesh, shape):
    """A DTensor of global ``shape`` over this rank's ``local`` shard."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=shape, stride=stride)


def full_tensor(x):
    """A DTensor's global tensor on every rank (plain tensors pass). A dim
    that several mesh axes shard holds chunk ``i * n_minor + j`` at (i, j)
    (``shard_of``), so its gathers run from the minor axis to the major."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, out, sizes = x.device_mesh, x.to_local(), axis_sizes(x.device_mesh)
    for i, entry in enumerate(spec_of(x)):
        for name in reversed(_axes(entry)):
            if sizes[name] > 1:
                out = all_gather(out, mesh.get_group(name), i)
    return out


def map_tree(fn, *trees):
    """fn over the leaves of the first tree (nested dicts and tuples: the
    decode state's caches are tuples), with the matching entries of the
    others (a spec tree's leaves are tuples). ``optimizer.tree_map`` takes
    tuples as leaves."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: map_tree(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, tuple):
        return tuple(map_tree(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def distribute(tree, specs, mesh):
    """Full tensors -> DTensors of this rank's shards under ``specs`` (the
    spec tree shaped like ``tree``)."""
    return map_tree(lambda t, s: from_local(shard_of(t, s, mesh), s, mesh,
                                            t.shape), tree, specs)


def to_local(tree):
    """DTensor leaves -> their local tensors (sharing storage)."""
    from torch.distributed.tensor import DTensor
    return map_tree(lambda t: t.to_local() if isinstance(t, DTensor) else t,
                    tree)


def reduce_grads(grad: torch.Tensor, spec: tuple,
                 mc: MeshCtx) -> torch.Tensor:
    """This rank's gradient of a param shard under ``spec`` summed over the
    batch shards, in the param's layout. A leaf that data shards arrives
    summed over data already (its gather's backward reduce-scattered it),
    so it is all-reduced over "pod" alone; any other leaf (the embedding,
    the norms) over "pod" x "data". "pod" replicates every param, as the
    reference's specs do."""
    sharded = mc.fsdp is not None and any("data" in _axes(e) for e in spec)
    group = (mc.pod_group if mc.pods > 1 else None) if sharded \
        else mc.batch_group
    return grad if group is None else all_reduce(grad, group)


def replication(spec: tuple, mesh) -> int:
    """How many ranks hold each shard of a leaf under ``spec``."""
    named = {a for entry in spec for a in _axes(entry)}
    out = 1
    for a, n in axis_sizes(mesh).items():
        if a not in named:
            out *= n
    return out
