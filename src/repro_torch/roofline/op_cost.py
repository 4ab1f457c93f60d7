"""The port's cost source: what one call dispatches, counted op by op (the
counterpart of ``repro/roofline/hlo_cost.py``).

The reference reads a compiled XLA module's HLO text. The port has no HLO:
``count(fn, *args)`` runs ``fn`` under a ``TorchDispatchMode`` and counts
every ATen op it dispatches, its backward and remat recompute included, as
they run (XLA's module holds them too). Under a ``FakeTensorMode`` and a
fake process group (``launch/dryrun.py``) nothing is allocated and nothing
moves, so one rank's step at the production meshes' shapes counts in
seconds. ``Cost`` has ``hlo_cost.Cost``'s fields, counted with its
semantics:

- ``flops``: a matmul (``mm``, ``addmm``, ``bmm``, ``baddbmm``, and ``dot``
  and ``mv``) 2 |result| K; a convolution 2 |result| window Cin/groups (its
  backward the same for each gradient it computes); any other op that
  writes memory |result|; views, metadata and allocation without a write
  (``empty``) 0.
- ``bytes``: operand bytes plus result bytes of every op that writes
  memory (an op that overwrites its destination, ``copy_``, ``fill_``,
  ``zero_``, reads no destination).
- ``bytes_fused``: the same, for the reference's ``_MATERIAL_OPS`` alone
  (matmuls, convolutions, copies, gathers, scatters, index ops, ``cat``,
  sorts, collectives) and the kernel records.
- ``coll_bytes``, ``coll_by_kind``, ``coll_count``: every collective of
  ``torch.distributed`` (the port's ``sharding/spmd.py`` collectives,
  FSDP's gathers included: they are real traffic) and of DTensor's
  functional collectives, by the reference's kinds. An all-gather counts
  its gathered result, an all-reduce its result, a reduce-scatter its
  result times the group size (its input), an all-to-all its result;
  ``spmd.exchange``'s sends and receives (``batch_isend_irecv``) are a
  "collective-permute" of the larger of the bytes sent and received. A
  ``broadcast`` has no kind among the reference's five (XLA's
  partitioner emits none for these steps): it counts as
  "collective-broadcast", which no sharded step calls.
- ``kernels``: one record for each hand-written kernel that a wrapper
  would have launched on a fake tensor (``kernels.fake_launch``): its
  shape and the ``(flops, bytes)`` of its ``KernelSpec.cost``
  (``core/provision/autotune.py``). The wrapper launches nothing there, so
  the count is the card's program, not the plain version's arithmetic.

**The memory term.** The reference's roofline reads ``bytes_fused``,
because XLA fuses elementwise work on a TPU. The port runs eagerly: each
elementwise op is its own kernel and its operands and result go through
HBM (olmo-1b's non-matmul work takes 658 of a step's 947 device ms on the
H100). So the port's ``roofline/analysis.py`` reads ``bytes``; it keeps
``bytes_fused`` beside it, as what a fused program would move.

``peak_bytes``: the peak of live bytes over the storages the call made
(its arguments' storages are the caller's and count nothing); on CUDA each
storage rounded up to the caching allocator's 512-byte blocks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")

_MATMULS = {"mm": 1, "addmm": 2, "bmm": 1, "baddbmm": 2, "dot": 1, "mv": 1}
_CONVS = {"convolution", "convolution_backward"}
_MATERIAL = {*_MATMULS, *_CONVS, "copy_", "copy", "clone", "index",
             "index_select", "index_put", "index_put_", "_index_put_impl_",
             "index_add", "index_add_", "index_copy", "index_copy_",
             "gather", "scatter", "scatter_", "scatter_add", "scatter_add_",
             "scatter_reduce", "scatter_reduce_", "embedding",
             "embedding_dense_backward", "cat", "sort", "topk",
             "slice_scatter", "select_scatter", "as_strided_scatter",
             "take", "masked_select", "nonzero"}
# ops that write their first operand without reading it
_OVERWRITE = {"copy_", "fill_", "zero_", "normal_", "uniform_",
              "random_", "bernoulli_", "exponential_"}
# ops that move no data: views (besides the schema's own, ``is_view``),
# metadata, and allocation without a write
_FREE = {"_unsafe_view", "_reshape_alias", "lift_fresh", "empty",
         "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
         "is_same_size", "_local_scalar_dense", "record_stream", "set_",
         "resize_", "_has_compatible_shallow_copy_type", "is_pinned"}
_FREE_NAMESPACES = {"prim", "c10d", "_c10d_functional", "profiler",
                    "_dtensor"}
CUDA_BLOCK = 512             # the caching allocator's smallest block


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0        # every op that writes memory
    bytes_fused: float = 0.0  # matmuls, copies, index ops, collectives,
                              # kernels: what a fused program would move
    coll_bytes: float = 0.0
    coll_by_kind: dict = dataclasses.field(default_factory=dict)
    coll_count: dict = dataclasses.field(default_factory=dict)
    kernels: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0

    def kernel_tally(self) -> dict:
        """{kernel: {"launches", "flops", "bytes"}} over the records."""
        out: dict = {}
        for rec in self.kernels:
            t = out.setdefault(rec["name"],
                               {"launches": 0, "flops": 0, "bytes": 0})
            t["launches"] += 1
            t["flops"] += rec["flops"]
            t["bytes"] += rec["bytes"]
        return out

    def program(self) -> dict:
        """Every field that the program fixes, whatever the device: the
        counts, the collectives and the kernel records (not the peak, whose
        blocks round by device)."""
        return {"flops": self.flops, "bytes": self.bytes,
                "bytes_fused": self.bytes_fused,
                "coll_bytes": self.coll_bytes,
                "coll_by_kind": dict(sorted(self.coll_by_kind.items())),
                "coll_count": dict(sorted(self.coll_count.items())),
                "kernels": list(self.kernels)}

    def as_dict(self) -> dict:
        out = self.program()
        out["kernels"] = self.kernel_tally()
        out["peak_bytes"] = self.peak_bytes
        return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> list:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _name(func) -> tuple[str, str]:
    """(namespace, op name) of an OpOverload."""
    return func.namespace, func._schema.name.split("::")[-1]


def _matmul_k(name: str, args) -> int:
    """K of a matmul: the last dim of its first matrix operand."""
    return args[_MATMULS[name] - 1].shape[-1]


def _conv_flops(name: str, args, outs) -> float:
    """2 |forward result| window Cin/groups, once for each gradient a
    ``convolution_backward`` computes."""
    if name == "convolution":
        w, result = args[1], outs[0]
        return 2.0 * result.numel() * w[0].numel()
    grad_out, w, mask = args[0], args[2], args[10]
    return 2.0 * grad_out.numel() * w[0].numel() * \
        sum(1 for m in mask[:2] if m)


_ACTIVE: list["Counter"] = []


def active() -> "Counter | None":
    """The innermost counter that is running, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def record_kernel(name: str, shape: dict, **cost_kw) -> None:
    """A kernel wrapper's launch on fake tensors: its ``KernelSpec.cost``
    at ``shape`` (``cost_kw`` passed on) goes to the running counter,
    flops and bytes, and a record; raises when no counter runs, since a
    fake tensor outside a count would reach a kernel that nothing
    launches."""
    counter = active()
    if counter is None:
        raise RuntimeError(
            f"a fake tensor reached the {name} kernel's wrapper outside a "
            "count (roofline.op_cost.count): nothing would launch it")
    from repro_torch.core.provision.autotune import KERNELS
    flops, nbytes = KERNELS[name].cost(shape, **cost_kw)
    cost = counter.cost
    cost.flops += flops
    cost.bytes += nbytes
    cost.bytes_fused += nbytes
    cost.kernels.append({"name": name, "shape": dict(shape),
                         "flops": flops, "bytes": nbytes})


# -- collectives ---------------------------------------------------------
# (kind, bytes of what it reads, bytes of what it writes, bytes it counts)
# for each wrapped call, from its arguments and its result
def _sum(ts) -> int:
    return sum(_nbytes(t) for t in _tensors(ts))


def _dist_sizes(name, a, kw, result):
    def arg(i, key):
        return a[i] if len(a) > i else kw.get(key)
    if name in ("all_gather", "all_gather_into_tensor"):
        out, src = _sum(arg(0, "tensor_list" if name == "all_gather"
                            else "output_tensor")), _sum(arg(1, "tensor"))
        return "all-gather", src, out, out
    if name == "all_reduce":
        n = _sum(arg(0, "tensor"))
        return "all-reduce", n, n, n
    if name in ("reduce_scatter", "reduce_scatter_tensor"):
        out, src = _sum(arg(0, "output")), _sum(arg(1, "input_list" if
                                                 name == "reduce_scatter"
                                                 else "input"))
        return "reduce-scatter", src, out, src
    if name in ("all_to_all", "all_to_all_single"):
        out, src = _sum(arg(0, "output_tensor_list" if name == "all_to_all"
                            else "output")), _sum(arg(1, "input"))
        return "all-to-all", src, out, out
    if name == "broadcast":
        n = _sum(arg(0, "tensor"))
        return "collective-broadcast", n, n, n
    if name in ("send", "recv"):
        n = _sum(arg(0, "tensor"))
        return "collective-permute", n, n, n
    ops = arg(0, "p2p_op_list") or []
    sent = sum(_nbytes(op.tensor) for op in ops
               if op.op in (torch.distributed.isend, torch.distributed.send))
    got = sum(_nbytes(op.tensor) for op in ops) - sent
    return "collective-permute", sent, got, max(sent, got)


def _funcol_sizes(name, a, kw, result):
    src, out = _sum(a[0] if a else None), _sum(result)
    if name.startswith("all_gather"):
        return "all-gather", src, out, out
    if name.startswith("all_reduce"):
        return "all-reduce", src, out, out
    if name.startswith("reduce_scatter"):
        return "reduce-scatter", src, out, src
    if name.startswith("all_to_all"):
        return "all-to-all", src, out, out
    return "collective-broadcast", src, out, out


# the calls that ``spmd.watch_collectives`` wraps (isend and irecv show
# inside batch_isend_irecv's P2POps)
_DIST_CALLS = ("all_gather", "all_gather_into_tensor", "all_reduce",
               "reduce_scatter", "reduce_scatter_tensor", "broadcast",
               "all_to_all", "all_to_all_single", "send", "recv",
               "batch_isend_irecv")
_FUNCOL_CALLS = ("all_gather_tensor", "all_gather_tensor_autograd",
                 "all_gather_single", "all_gather_single_autograd",
                 "all_gather_into_tensor_coalesced", "all_reduce",
                 "all_reduce_coalesced", "reduce_scatter_tensor",
                 "reduce_scatter_tensor_autograd", "reduce_scatter_single",
                 "reduce_scatter_single_autograd",
                 "reduce_scatter_tensor_coalesced", "all_to_all_single",
                 "all_to_all_single_autograd", "broadcast")


class Counter(TorchDispatchMode):
    """Counts what runs while it is entered into ``self.cost`` (see the
    module's docstring). ``known``: tensors (any tree of them, DTensors'
    local shards included) that exist before the call, whose storages
    count nothing in ``peak_bytes``."""

    def __init__(self, known=()):
        super().__init__()
        self.cost = Cost()
        self._storages = WeakIdKeyDictionary()
        self._live = 0
        self._depth = 0
        self._saved: list = []
        for t in _locals(known):
            self._track(t, count=False)

    # -- memory --
    def _track(self, t: torch.Tensor, count: bool = True) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        if st in self._storages:
            return
        n = st.nbytes() if count else 0
        if n and t.device.type == "cuda":
            n = -(-n // CUDA_BLOCK) * CUDA_BLOCK
        self._storages[st] = n
        if n:
            self._live += n
            self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)
            weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self._live -= n

    # -- ops --
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs its local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        ns, name = _name(func)
        if ns in _FREE_NAMESPACES or name in _FREE or func.is_view:
            return out
        ins = _tensors((args, kwargs))
        if name in _OVERWRITE:
            ins = ins[1:]
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        cost = self.cost
        if name in _MATMULS:
            cost.flops += 2.0 * outs[0].numel() * _matmul_k(name, args)
        elif name in _CONVS:
            cost.flops += _conv_flops(name, args, outs)
        else:
            cost.flops += sum(t.numel() for t in outs)
        cost.bytes += nbytes
        if name in _MATERIAL:
            cost.bytes_fused += nbytes
        return out

    # -- collectives --
    def _collective(self, sizes: Callable, name: str, orig: Callable):
        def call(*a, **kw):
            self._depth += 1
            try:
                result = orig(*a, **kw)
            finally:
                self._depth -= 1
            if not self._depth:
                kind, src, dst, counted = sizes(name, a, kw, result)
                c = self.cost
                c.coll_bytes += counted
                c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0) + counted
                c.coll_count[kind] = c.coll_count.get(kind, 0) + 1
                c.bytes += src + dst
                c.bytes_fused += src + dst
            return result
        return call

    def __enter__(self):
        import torch.distributed as dist
        import torch.distributed._functional_collectives as funcol
        for mod, names, sizes in ((dist, _DIST_CALLS, _dist_sizes),
                                  (funcol, _FUNCOL_CALLS, _funcol_sizes)):
            for name in names:
                orig = getattr(mod, name, None)
                if callable(orig):
                    self._saved.append((mod, name, orig))
                    setattr(mod, name, self._collective(sizes, name, orig))
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)
            for mod, name, orig in reversed(self._saved):
                setattr(mod, name, orig)
            self._saved.clear()


def _locals(tree) -> list:
    """The plain tensors of a tree: a DTensor's local shard, a tensor as it
    is (dicts, lists and tuples walked)."""
    out = []
    for t in tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            out.append(t.to_local())
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def local_bytes(tree) -> int:
    """The bytes of a tree's tensors on this rank (a DTensor's local
    shard), each storage once."""
    seen, total = set(), 0
    for t in _locals(tree):
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


@contextlib.contextmanager
def counting(known=()):
    """``with counting(known=args) as cost:`` counts the block into the
    yielded ``Cost``."""
    with Counter(known) as counter:
        yield counter.cost


def count(fn: Callable, *args: Any, **kw: Any) -> Cost:
    """The ``Cost`` of ``fn(*args, **kw)`` (its arguments' storages count
    nothing in ``peak_bytes``)."""
    with counting(known=(args, kw)) as cost:
        fn(*args, **kw)
    return cost
