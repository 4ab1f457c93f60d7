"""Where a dry-run cell's peak of live bytes sits.

    PYTHONPATH=src python tools/dryrun_peak.py --arch zamba2-7b \\
        --shape train_4k [--multi-pod] [--reduced] [--mesh 2x2]

Counts the cell as the dry-run CLI does (``repro_torch.launch.dryrun``'s
``count_cell``, fake CPU tensors on a fake mesh) with its counter (``roofline/op_cost.Counter``, ``peak_bytes``) replaced
by ``PeakCounter``, which also records, at the step's peak of live bytes:

- the op whose result made the peak, and the ``record_function`` scopes
  open there, innermost last;
- the live bytes at the peak by the scope and op that made each storage.

Each model layer's call runs under a scope of its own here,
``layer_fwd[<block>]`` (``transformer.layer_fwd`` is wrapped for the run
only), so that a storage names the kind of layer that made it: the
hybrid's shared attention block is ``layer_fwd[shared_attn]``. Storages
made by the backward pass outside any scope are ``(no scope)``. The
result is printed as one JSON object; nothing is written. ``--reduced``
counts the config's ``.reduced()`` at the shape's sizes; ``--mesh`` (e.g.
``2x2``) takes a mesh other than the production one.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import sys
import weakref
from pathlib import Path

from torch.profiler import record_function

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch.mesh import production_shape  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.roofline import op_cost  # noqa: E402

NO_SCOPE = "(no scope)"


class PeakCounter(op_cost.Counter):
    """``op_cost.Counter`` that keeps the live bytes by a key of each
    storage: ``key(counter, tensor)``, by default (innermost
    ``record_function`` scope, op) of the storage's maker; each key's own
    peak of live bytes (``peak_by``) and largest storage (``largest_by``);
    and, at each new peak of all live bytes, a copy of the live bytes by
    key, with the op and the open scopes."""

    def __init__(self, known=(), key=None):
        self._scopes: list = []
        self._op = "(argument)"
        self._key = key or (lambda counter, t: (
            counter._scopes[-1] if counter._scopes else NO_SCOPE,
            counter._op))
        self._by: dict = {}
        self.peak_by: dict = {}
        self.largest_by: dict = {}
        self.at_peak: dict = {"op": None, "scopes": [], "live": {}}
        super().__init__(known)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        ns, name = op_cost._name(func)
        if ns == "profiler" and name.startswith("_record_function_enter"):
            self._scopes.append(args[0])
        elif ns == "profiler" and name.startswith("_record_function_exit"):
            if self._scopes:
                self._scopes.pop()
        self._op = name
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _track(self, t, count: bool = True) -> None:
        live, peak = self._live, self.cost.peak_bytes
        super()._track(t, count)
        n = self._live - live
        if n <= 0:
            return
        key = self._key(self, t)
        self._by[key] = self._by.get(key, 0) + n
        self.peak_by[key] = max(self.peak_by.get(key, 0), self._by[key])
        self.largest_by[key] = max(self.largest_by.get(key, 0), n)
        weakref.finalize(t.untyped_storage(), self._drop, key, n)
        if self.cost.peak_bytes > peak:
            self.at_peak = {"op": self._op, "scopes": list(self._scopes),
                            "live": dict(self._by)}

    def _drop(self, key, n: int) -> None:
        self._by[key] -= n


def _scoped_layer_fwd(orig):
    @functools.wraps(orig)
    def layer_fwd(block, *args, **kw):
        with record_function(f"layer_fwd[{block}]"):
            return orig(block, *args, **kw)
    return layer_fwd


def peak_of_count(cfg, shape, mesh_shape) -> dict:
    """``dryrun.count_cell`` of ``cfg`` at ``shape`` (a ``ShapeConfig``) on
    a fake mesh of ``mesh_shape``, and where its peak of live bytes sits
    (see the module's docstring)."""
    counters = []

    @contextlib.contextmanager
    def counting(known=()):
        with PeakCounter(known) as counter:
            counters.append(counter)
            yield counter.cost

    orig_counting, orig_layer = op_cost.counting, T.layer_fwd
    op_cost.counting, T.layer_fwd = counting, _scoped_layer_fwd(orig_layer)
    try:
        got = DR.count_cell(cfg, shape, tuple(mesh_shape),
                            tcfg=DR.TrainConfig(), device="cpu")
    finally:
        op_cost.counting, T.layer_fwd = orig_counting, orig_layer
    at = counters[-1].at_peak
    live = sorted(((b, scope, op) for (scope, op), b in at["live"].items()
                   if b), reverse=True)
    by_scope: dict = {}
    for b, scope, _ in live:
        by_scope[scope] = by_scope.get(scope, 0) + b
    return {
        "arch": cfg.name, "mesh_shape": list(mesh_shape),
        "temp_bytes": got["cost"].peak_bytes,
        "predicted_peak_bytes": got["args_bytes"] + got["cost"].peak_bytes,
        "peak_op": at["op"], "peak_scopes": at["scopes"],
        "live_by_scope": dict(sorted(by_scope.items(),
                                     key=lambda kv: -kv[1])),
        "live_top": [{"bytes": b, "scope": s, "op": o}
                     for b, s, o in live[:12]],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default=None, help="e.g. 2x2")
    args = ap.parse_args(argv)
    mesh = tuple(int(n) for n in args.mesh.split("x")) if args.mesh \
        else production_shape(multi_pod=args.multi_pod)[0]
    cfg = get_arch(args.arch)
    out = {"shape": args.shape, "multi_pod": args.multi_pod,
           "reduced": args.reduced,
           **peak_of_count(cfg.reduced() if args.reduced else cfg,
                           SHAPES[args.shape], mesh)}
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
