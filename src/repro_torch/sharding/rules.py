"""Logical-axis sharding rules (the port of ``repro/sharding/rules.py``).

The reference's model code annotates tensors with *logical* axis names; a
launcher installs an ``AxisRules`` mapping logical names to mesh axes for
the active mesh. The port's sharded steps pass each rank's local tensors,
so its model carries no such annotation (the reference's
``with_sharding_constraint`` calls have no counterpart); the rules give the
spec functions below their mesh axes.

Logical axes:
  batch   : data-parallel batch           -> ("pod", "data") / ("data",)
  tp      : tensor-parallel (heads, d_ff, experts, vocab)   -> ("model",)
  kvseq   : KV-cache / long-context sequence sharding       -> ("model",)
  longseq : 500k decode KV sequence        -> ("data", "model") combined
  zero    : optimizer-state / FSDP weight sharding          -> ("data",)

A spec is a plain tuple with one entry per tensor dim: None, a mesh axis
name, or a tuple of names (the reference's ``PartitionSpec`` entries, which
the tests compare entry for entry). ``spmd.placements`` turns one into a
DTensor's placements on a ``DeviceMesh``. The rules state is per process,
as the reference's is.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.sharding.mesh import axis_names, axis_sizes


@dataclasses.dataclass
class AxisRules:
    mesh: object                      # AbstractMesh, DeviceMesh or None
    table: dict[str, tuple[str, ...]]

    @classmethod
    def for_mesh(cls, mesh) -> "AxisRules":
        axes = axis_names(mesh)
        batch = tuple(a for a in ("pod", "data") if a in axes)
        model = ("model",) if "model" in axes else ()
        return cls(mesh=mesh, table={
            "batch": batch,
            "tp": model,
            "kvseq": model,
            "longseq": batch + model,
            "zero": tuple(a for a in ("data",) if a in axes),
        })

    def size(self, axis: str) -> int:
        return axis_sizes(self.mesh)[axis]


_ACTIVE: Optional[AxisRules] = None


def set_rules(rules: Optional[AxisRules]) -> None:
    global _ACTIVE
    _ACTIVE = rules


def current_rules() -> Optional[AxisRules]:
    return _ACTIVE


def logical_to_spec(logical: Sequence[Optional[str]],
                    rules: Optional[AxisRules] = None) -> tuple:
    rules = rules or _ACTIVE
    if rules is None:
        return ()
    out = []
    for name in logical:
        if name is None:
            out.append(None)
        else:
            mapped = rules.table.get(name, ())
            # an unmapped name is unsharded (PartitionSpec reads () as None)
            out.append(None if not mapped else
                       mapped if len(mapped) != 1 else mapped[0])
    return tuple(out)


# ---------------------------------------------------------------------------
# parameter sharding specs (path-walk over the real param tree)
# ---------------------------------------------------------------------------

_COL_TP = {"wq", "wk", "wv", "wg", "wr", "w_up", "w_gate", "cm_wk",
           "cm_wr", "z_proj", "x_proj", "conv_x", "lm_head"}
_ROW_TP = {"wo", "out_proj", "cm_wv", "w_down"}
_VEC_TP = {"conv_b_x", "gate_norm", "ln_x"}


def _leaf_spec(path: tuple[str, ...], ndim: int, cfg, tp) -> tuple:
    """Core spec for one param leaf; leading stack dims padded."""
    key = path[-1]
    in_moe = "moe" in path and "shared" not in path

    if key == "embed":
        if cfg.n_codebooks:
            return (None, None, tp)
        # tied tables serve the lookup AND the logits: vocab-sharded keeps
        # the logits tp-sharded; untied tables shard d_model instead
        return (tp, None) if cfg.tie_embeddings else (None, tp)
    if in_moe and key in ("w_gate", "w_up", "w_down"):
        core = (tp, None, None)               # experts over tp (EP)
    elif key in _COL_TP:
        core = (None, tp)
    elif key in _ROW_TP:
        core = (tp, None)
    elif key in _VEC_TP:
        core = (tp,)
    else:
        core = ()
    return (None,) * (ndim - len(core)) + core


def _walk(tree, fn, path=()):
    """{key: fn(path, leaf)} over nested dicts."""
    return {k: _walk(v, fn, (*path, str(k))) if isinstance(v, dict)
            else fn((*path, str(k)), v) for k, v in tree.items()}


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def param_specs(cfg, rules: Optional[AxisRules] = None,
                fsdp: bool = True, param_shapes=None):
    """Spec tree exactly matching ``init_params(cfg)``.

    Specs are assigned by walking the param tree (``param_shapes``: leaves
    with a ``shape``, or shapes; ``model.param_shapes(cfg)`` by default,
    which allocates nothing) and matching leaf paths. With ``fsdp``, one
    extra dimension per leaf (never the leading stacked-layer dim, never
    the embedding) shards over the data axis: the last dim that is
    unsharded and divides.
    """
    rules = rules or _ACTIVE
    tp = None
    if rules is not None:
        mapped = rules.table.get("tp", ())
        tp = mapped[0] if len(mapped) == 1 else (mapped or None)
    if param_shapes is None:
        from repro_torch.models import model as _M
        param_shapes = _M.param_shapes(cfg)

    data_axes = rules.table.get("zero", ()) if rules else ()
    data = data_axes[0] if data_axes else None
    n_data = rules.size(data) if data else 1

    def one(path, leaf):
        shape = _shape(leaf)
        spec = _leaf_spec(path, len(shape), cfg, tp)
        if fsdp and data and n_data > 1 and path[-1] != "embed" \
                and len(shape) >= 2:
            parts = list(spec) + [None] * (len(shape) - len(spec))
            for i in range(len(shape) - 1, 0, -1):
                if parts[i] is None and shape[i] % n_data == 0 \
                        and shape[i] >= n_data:
                    parts[i] = data
                    break
            spec = tuple(parts)
        return spec

    return _walk(param_shapes, one)


# ---------------------------------------------------------------------------
# decode-state / batch specs
# ---------------------------------------------------------------------------

def decode_state_specs(cfg, global_batch: int,
                       rules: Optional[AxisRules] = None,
                       layout: str = "fsdp"):
    """Spec tree matching ``transformer.init_decode_state``.

    layout="fsdp" (baseline): batch over data when divisible; kv-heads over
    model when divisible, else the sequence dim shards over model; batch-1
    long-context decode shards the sequence over data AND model.
    layout="resident": batch replicated. The reference's attention branch
    for "resident" (the KV sequence over data x model) tests
    ``layout == "resident"`` after ``layout`` was rebound to the layout
    dict, so it never fires, and the attention caches take the fsdp rules
    with the batch replicated; the port copies that (ROADMAP C).
    """
    from repro_torch.models.transformer import build_layout
    rules = rules or _ACTIVE
    if rules is None:
        return None
    tbl = rules.table
    tp = tbl.get("tp", (None,))[0] if tbl.get("tp") else None
    batch_axes = tbl.get("batch", ())
    bsz = 1
    for a in batch_axes:
        bsz *= rules.size(a)
    b_ax = batch_axes if (batch_axes and global_batch % bsz == 0
                          and global_batch >= bsz) else None
    if layout == "resident":
        b_ax = None
    if b_ax is not None and len(b_ax) == 1:
        b_ax = b_ax[0]
    tp_size = rules.size(tp) if tp else 1

    def attn_spec():
        # (stack..., B, S, KV, D)
        seq_ax = None
        if b_ax is None and batch_axes:
            # batch too small to shard -> the sequence takes the data axis
            seq_ax = batch_axes if len(batch_axes) > 1 else batch_axes[0]
        if cfg.n_kv_heads % tp_size == 0 and tp_size > 1:
            return (b_ax, seq_ax, tp, None)
        if seq_ax is not None and tp is not None:
            return (b_ax, tuple(batch_axes) + (tp,), None, None)
        return (b_ax, tp, None, None)       # seq over model

    def stack(nstack, core):
        return (None,) * nstack + tuple(core)

    kinds = build_layout(cfg)
    if kinds["kind"] == "uniform":
        if kinds["block"] == "rwkv":
            st = (stack(1, (b_ax, tp, None, None)),      # wkv (B,H,K,V)
                  stack(1, (b_ax, None, None)),          # tm last token
                  stack(1, (b_ax, None, None)))          # cm last token
            return {"layers": st}
        core = attn_spec()
        return {"layers": (stack(1, core), stack(1, core))}

    # periodic
    if kinds["inner_block"] == "mamba":
        inner = (stack(2, (b_ax, tp, None, None)),       # ssm (B,H,N,P)
                 stack(2, (b_ax, None, tp)))             # conv (B,W-1,C)
        trailing = (stack(1, (b_ax, tp, None, None)),
                    stack(1, (b_ax, None, tp)))
    else:
        core = attn_spec()
        inner = (stack(2, core), stack(2, core))
        trailing = (stack(1, core), stack(1, core))
    core = attn_spec()
    if kinds["single_block"] == "cross_attn":
        single = (stack(1, (b_ax, None, None, None)),
                  stack(1, (b_ax, None, None, None)))
    else:
        single = (stack(1, core), stack(1, core))
    return {"inner": inner, "single": single, "trailing": trailing}


def batch_axis(rules: Optional[AxisRules], global_batch: int,
               layout: str = "fsdp"):
    """The batch dim's spec entry: the batch axes when they divide the
    global batch (one name, or a tuple of names), else None."""
    if rules is None or layout == "resident":
        return None
    axes = rules.table.get("batch", ())
    size = 1
    for a in axes:
        size *= rules.size(a)
    if axes and global_batch % size == 0 and global_batch >= size:
        return axes if len(axes) > 1 else axes[0]
    return None


def batch_specs(cfg, shape_kind: str, global_batch: int,
                rules: Optional[AxisRules] = None, layout: str = "fsdp"):
    """Input-batch specs per shape kind (train, prefill, decode)."""
    b = batch_axis(rules or _ACTIVE, global_batch, layout)
    out = {"tokens": (b, None) if not cfg.n_codebooks else (b, None, None)}
    if shape_kind == "train":
        out["labels"] = out["tokens"]
    if shape_kind == "decode":
        out["cache_len"] = (b,)
    if cfg.family == "vlm":
        out["vision"] = (b, None, None)
    return out
