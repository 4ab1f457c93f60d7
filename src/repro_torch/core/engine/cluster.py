"""Cluster capacity model (ACAI §3.3.1 scaled up).

A copy of ``repro/core/engine/cluster.py``, with its imports
in ``repro_torch.core``.

The paper schedules jobs onto shared cloud capacity; the seed engine only
gated on a per-(project, user) quota, which admits unbounded aggregate
resources. ``Cluster`` holds finite totals per resource dimension and the
scheduler reserves/releases against them on launch/terminal events, so the
engine models a real shared deployment: admission waits for capacity, and
utilization is observable.

Totals are derived from the pricing model's node shapes — a "node" is the
largest allocatable amount per dimension in ``pricing.grid()`` — times a
node count, mirroring how a real cluster is a number of machine shapes.
"""
from __future__ import annotations

import threading
from typing import Any, Optional


class CapacityError(RuntimeError):
    """A reservation that can never fit (exceeds cluster totals)."""


class Cluster:
    """Finite multi-dimensional capacity with per-job reservations.

    All mutating calls are thread-safe (the ThreadPoolRunner finalizes jobs
    from worker threads). Missing dimensions in a job's resource dict are
    charged at ``defaults`` (the pricing minimum), matching how
    ``Pricing.job_cost`` bills them. Dimensions the cluster does not have
    (e.g. ``chips`` on a CPU pool) are kept in the charge with an implicit
    capacity of zero, so ``fits``/``ever_fits`` reject instead of silently
    admitting the job as if the request were free.

    ``name`` identifies the pool in a heterogeneous deployment (one
    Cluster per accelerator family; see ``core/engine/placement.py``).
    ``spot`` marks a preemptible pool (priced below on-demand, capacity
    reclaimable at any time — the scheduler models a reclamation as a
    forced preemption) and ``reclaim_rate`` is its expected reclamations
    per second, which the placement layer prices into spot scores.
    """

    def __init__(self, capacity: dict[str, float],
                 defaults: Optional[dict[str, float]] = None,
                 name: str = "default", *, spot: bool = False,
                 reclaim_rate: float = 0.0,
                 node_shape: Optional[dict[str, float]] = None,
                 close_gang_pods: Optional[int] = None):
        self.name = name
        self.spot = spot
        self.reclaim_rate = reclaim_rate
        self.capacity = {k: float(v) for k, v in capacity.items()}
        self.defaults = dict(defaults or {})
        # ``used``/``capacity`` are read lock-free by scheduler hot paths
        # (dashboards, snapshots) — a torn read there is a stale gauge,
        # not a correctness bug — so they deliberately carry no
        # guarded-by annotation; every *write* still happens under _lock
        self.used: dict[str, float] = {k: 0.0 for k in self.capacity}
        self._held: dict[str, dict[str, float]] = {}  # guarded-by: _lock
        # gang holds: job_id -> (per-pod charge, pod count). The aggregate
        # (n_pods x per-pod) also lives in ``_held`` so release/settle paths
        # need no gang awareness; this record is what makes a shrink-to-k
        # resize and partial-hold audits possible.
        self._gangs: dict[str, tuple[dict[str, float], int]] = {}  # guarded-by: _lock
        # node-granular accounting (opt in): a pool built from whole nodes
        # of ``node_shape`` tracks per-node free vectors so a gang's pods
        # must each pack onto SOME node, not merely fit the pool aggregate.
        # job_id -> [(node_idx, per-pod charge), ...]
        self.node_shape = dict(node_shape) if node_shape else None
        self._node_free: list[dict[str, float]] = []  # guarded-by: _lock
        self._node_holds: dict[str, list[tuple[int, dict[str, float]]]] = {}  # guarded-by: _lock
        if self.node_shape:
            self._node_free = [dict(self.node_shape)
                               for _ in range(self._target_nodes())]
        # node health: indices of down nodes (failed or draining) are
        # excluded from packing and their shape is subtracted from the
        # aggregate capacity; residents of a *failed* node are handed to
        # the caller to kill/retry, residents of a *drained* node finish
        # naturally (the pool runs over-committed meanwhile).
        # node_idx -> "failed" | "drained"
        self._down: dict[int, str] = {}  # guarded-by: _lock
        # topology: how many gang pods this pool can host "close" (one
        # interconnect island). None = unconstrained; the placement layer
        # penalizes (not rejects) close-topology gangs that exceed it.
        self.close_gang_pods = close_gang_pods
        # accounting-drift counters: a release that would drive ``used``
        # negative is clamped but *counted* (see ``release``), so a
        # double-release bug surfaces in stats instead of silently
        # vanishing into the clamp
        self.stats = {"release_underflow": 0, "release_underflow_amount": 0.0}
        self._lock = threading.RLock()

    def _target_nodes(self) -> int:
        """Node count implied by capacity / node_shape (max across dims
        tolerates a partially-shaped pool)."""
        counts = [self.capacity.get(d, 0.0) / amt
                  for d, amt in (self.node_shape or {}).items() if amt > 0]
        return max(1, int(round(max(counts, default=1))))

    # -- construction ---------------------------------------------------
    @classmethod
    def from_pricing(cls, pricing, nodes: int = 8,
                     name: str = "default") -> "Cluster":
        """Totals = ``nodes`` x the largest node shape the pricing allocates."""
        capacity = {name_: max(dim.values) * nodes
                    for name_, dim in pricing.dims.items()}
        defaults = {name_: dim.minimum for name_, dim in pricing.dims.items()}
        return cls(capacity, defaults, name=name)

    # -- normalization --------------------------------------------------
    def charge(self, resources: Optional[dict[str, Any]]) -> dict[str, float]:
        """The amounts a job is billed against capacity, per dimension.

        Dimensions requested but absent from ``capacity`` are included so
        admission rejects them (capacity for an unknown dimension is zero);
        dropping them would admit e.g. a ``tpu=8`` job onto a CPU pool for
        free."""
        resources = resources or {}
        req = {name: float(resources.get(name, self.defaults.get(name, 0.0)))
               for name in self.capacity}
        for name, amt in resources.items():
            if name not in req:
                req[name] = float(amt)
        return req

    # -- admission ------------------------------------------------------
    def fits(self, resources: Optional[dict[str, Any]]) -> bool:
        return self.fits_charge(self.charge(resources))

    def fits_charge(self, req: dict[str, float]) -> bool:
        """Admission check on a pre-computed charge (the scheduler caches
        charges at submit to keep the dispatch scan cheap)."""
        with self._lock:
            return all(self.used.get(n, 0.0) + amt
                       <= self.capacity.get(n, 0.0) + 1e-9
                       for n, amt in req.items())

    def ever_fits(self, resources: Optional[dict[str, Any]]) -> bool:
        """Could this job run on an empty cluster at all?"""
        return self.ever_fits_charge(self.charge(resources))

    def ever_fits_charge(self, req: dict[str, float]) -> bool:
        return all(amt <= self.capacity.get(n, 0.0) + 1e-9
                   for n, amt in req.items())

    def reserve(self, job_id: str,
                resources: Optional[dict[str, Any]]) -> dict[str, float]:
        req = self.charge(resources)
        with self._lock:
            if job_id in self._held:
                return self._held[job_id]
            if not all(self.used.get(n, 0.0) + amt
                       <= self.capacity.get(n, 0.0) + 1e-9
                       for n, amt in req.items()):
                raise CapacityError(f"{job_id}: {req} oversubscribes "
                                    f"{self.name}: {self.free()}")
            for n, amt in req.items():
                if n in self.used:
                    self.used[n] += amt
            self._held[job_id] = req
            return req

    # -- gang admission (atomic all-or-none) ----------------------------
    def _node_fits(self, free: dict[str, float],
                   pod: dict[str, float]) -> bool:
        return all(free.get(n, 0.0) + 1e-9 >= amt
                   for n, amt in pod.items() if amt > 0)

    def _pack_pods(self, pod: dict[str, float],
                   n_pods: int) -> Optional[list[int]]:
        """First-fit node indices for ``n_pods`` pods of shape ``pod``
        against the current free vectors — or None if they cannot all be
        placed. Pure planning: mutates nothing. Callers already hold the
        lock; re-entering the RLock here keeps the free-vector read
        atomic even for a future caller that does not."""
        with self._lock:
            shadow = [dict(f) for f in self._node_free]
            picked: list[int] = []
            for _ in range(n_pods):
                for i, free in enumerate(shadow):
                    if i in self._down:
                        continue    # dead/draining node: never packable
                    if self._node_fits(free, pod):
                        for n, amt in pod.items():
                            free[n] = free.get(n, 0.0) - amt
                        picked.append(i)
                        break
                else:
                    return None
            return picked

    def can_pack(self, per_pod: Optional[dict[str, Any]],
                 n_pods: int) -> bool:
        """Would ``n_pods`` pods of ``per_pod`` each fit on some node right
        now?  Pools without node accounting fall back to the aggregate
        check (any aggregate fit is trivially packable)."""
        pod = self.charge(per_pod)
        agg = {n: amt * n_pods for n, amt in pod.items()}
        with self._lock:
            if not self.fits_charge(agg):
                return False
            if self.node_shape is None:
                return True
            if n_pods == 1:
                # hot path (every single job on a node-shaped pool asks
                # this at dispatch): scan free vectors in place, no
                # shadow copies
                return any(self._node_fits(free, pod)
                           for i, free in enumerate(self._node_free)
                           if i not in self._down)
            return self._pack_pods(pod, n_pods) is not None

    def reserve_gang(self, job_id: str, per_pod: Optional[dict[str, Any]],
                     n_pods: int) -> dict[str, float]:
        """Atomically reserve ``n_pods`` pods of ``per_pod`` each:
        reserve-all-or-release-all, so a gang can never partially hold
        capacity. Returns the *aggregate* charge (which is what
        ``release``/settle later hand back). Idempotent per job_id."""
        if n_pods < 1:
            raise ValueError(f"{job_id}: gang needs n_pods >= 1")
        pod = self.charge(per_pod)
        agg = {n: amt * n_pods for n, amt in pod.items()}
        with self._lock:
            if job_id in self._held:
                return self._held[job_id]
            if not self.fits_charge(agg):
                raise CapacityError(f"{job_id}: gang {n_pods}x{pod} "
                                    f"oversubscribes {self.name}: "
                                    f"{self.free()}")
            if self.node_shape is not None:
                picked = self._pack_pods(pod, n_pods)
                if picked is None:
                    # aggregate fits but the pods cannot all be node-packed
                    raise CapacityError(
                        f"{job_id}: gang {n_pods}x{pod} does not pack "
                        f"onto {self.name}'s nodes")
                holds = []
                for i in picked:
                    for n, amt in pod.items():
                        self._node_free[i][n] = \
                            self._node_free[i].get(n, 0.0) - amt
                    holds.append((i, dict(pod)))
                self._node_holds[job_id] = holds
            for n, amt in agg.items():
                if n in self.used:
                    self.used[n] += amt
            self._held[job_id] = agg
            self._gangs[job_id] = (pod, n_pods)
            return agg

    def gang_of(self, job_id: str) -> Optional[tuple[dict[str, float], int]]:
        """(per-pod charge, pod count) for a live gang hold, else None."""
        with self._lock:
            g = self._gangs.get(job_id)
            return (dict(g[0]), g[1]) if g is not None else None

    def shrink_gang_hold(self, job_id: str, k: int) -> dict[str, float]:
        """Shrink a live gang reservation to ``k`` pods in place (elastic
        resize): frees the (n-k) surplus pods' charge — and their node
        slots — without ever dropping to zero pods held. Returns the
        per-dimension amount freed."""
        with self._lock:
            if job_id not in self._gangs:
                raise KeyError(f"{job_id}: no gang hold on {self.name}")
            pod, n = self._gangs[job_id]
            if not (1 <= k <= n):
                raise ValueError(f"{job_id}: shrink to {k} of {n} pods")
            drop = n - k
            freed = {dim: amt * drop for dim, amt in pod.items()}
            for dim, amt in freed.items():
                if dim in self.used:
                    self.used[dim] = max(0.0, self.used[dim] - amt)
            if job_id in self._node_holds:
                holds = self._node_holds[job_id]
                for i, pcharge in holds[k:]:
                    if i < len(self._node_free):
                        for dim, amt in pcharge.items():
                            self._node_free[i][dim] = \
                                self._node_free[i].get(dim, 0.0) + amt
                self._node_holds[job_id] = holds[:k]
            self._gangs[job_id] = (pod, k)
            self._held[job_id] = {dim: amt * k for dim, amt in pod.items()}
            return freed

    def release(self, job_id: str) -> Optional[dict[str, float]]:
        """Idempotent: releasing an unknown/already-released job is a no-op.

        A gang hold releases whole: every pod's charge (and node slot)
        comes back in the same call — release-all mirrors reserve-all.

        A release that would drive ``used`` below zero means the books
        drifted (a double-release or an externally-mutated ``used``); the
        value is still clamped to keep the pool usable, but the drift is
        counted in ``stats`` so it cannot silently mask an accounting bug.
        """
        with self._lock:
            req = self._held.pop(job_id, None)
            self._gangs.pop(job_id, None)
            for i, pod in self._node_holds.pop(job_id, []):
                if i < len(self._node_free):
                    for n, amt in pod.items():
                        self._node_free[i][n] = \
                            self._node_free[i].get(n, 0.0) + amt
            if req is not None:
                for n, amt in req.items():
                    if n in self.used:
                        left = self.used[n] - amt
                        if left < -1e-9:
                            self.stats["release_underflow"] += 1
                            self.stats["release_underflow_amount"] += -left
                            left = 0.0
                        self.used[n] = max(0.0, left)
            return req

    # -- node health ----------------------------------------------------
    def _mark_down(self, node_idx: int, kind: str) -> list[str]:
        if self.node_shape is None:
            raise ValueError(f"{self.name}: node health needs node_shape")
        with self._lock:
            if not (0 <= node_idx < len(self._node_free)):
                raise IndexError(f"{self.name}: no node {node_idx}")
            residents = []
            if node_idx not in self._down:
                self._down[node_idx] = kind
                # the node's whole shape leaves the aggregate books; live
                # usage stays until residents release, so the pool may run
                # over-committed exactly like a shrink under load
                for dim, amt in self.node_shape.items():
                    if dim in self.capacity:
                        self.capacity[dim] = max(
                            0.0, self.capacity[dim] - amt)
            else:
                self._down[node_idx] = kind
            for jid, holds in self._node_holds.items():
                if any(i == node_idx for i, _ in holds):
                    residents.append(jid)
            return residents

    def fail_node(self, node_idx: int) -> list[str]:
        """Kill a node: it stops packing, its shape leaves capacity, and
        the job_ids holding reservations on it are returned for the
        caller (the scheduler / fault injector) to fail — a gang with any
        pod on the node fails whole, since its reservation releases
        atomically. Reservations themselves are NOT touched here: the
        scheduler's settle path releases them when it fails the jobs."""
        return self._mark_down(node_idx, "failed")

    def drain_node(self, node_idx: int) -> list[str]:
        """Cordon a node: no new pods pack onto it, but residents keep
        running and release naturally. Returns the resident job_ids for
        observability."""
        return self._mark_down(node_idx, "drained")

    def node_health(self) -> dict[str, Any]:
        """{"nodes": total, "up": n, "failed": [...], "drained": [...]}
        — empty-ish for pools without node accounting."""
        with self._lock:
            failed = sorted(i for i, k in self._down.items()
                            if k == "failed")
            drained = sorted(i for i, k in self._down.items()
                             if k == "drained")
            total = len(self._node_free)
            return {"nodes": total, "up": total - len(self._down),
                    "failed": failed, "drained": drained}

    def up_nodes(self) -> list[int]:
        """Indices of schedulable nodes (for the fault injector's target
        draw — deterministic given the same history)."""
        with self._lock:
            return [i for i in range(len(self._node_free))
                    if i not in self._down]

    # -- elasticity -----------------------------------------------------
    def resize(self, capacity: dict[str, float]) -> dict[str, float]:
        """Set new totals for the given dimensions (others keep theirs).

        Reservations are untouched: shrinking below live usage leaves the
        pool *over-committed* (``used > capacity``) until the scheduler
        drains the overage — via the preemption path, or by letting the
        outliving jobs finish naturally. Returns the per-dimension
        overage (``used - capacity`` where positive) so the caller knows
        what must drain; new admissions are rejected meanwhile because
        ``fits`` already fails on an over-committed dimension.
        """
        with self._lock:
            for n, v in capacity.items():
                self.capacity[n] = float(v)
                self.used.setdefault(n, 0.0)
            if self.node_shape is not None:
                target = self._target_nodes()
                while len(self._node_free) < target:
                    self._node_free.append(dict(self.node_shape))
                # shrink only trims *empty* trailing nodes; nodes still
                # hosting pods survive until their gangs drain (the pool
                # is over-committed meanwhile, same as the aggregate books)
                busy = {i for holds in self._node_holds.values()
                        for i, _ in holds}
                while len(self._node_free) > target:
                    idx = len(self._node_free) - 1
                    if idx in busy:
                        break
                    self._node_free.pop()
                    self._down.pop(idx, None)
            return {n: self.used[n] - self.capacity[n]
                    for n in capacity
                    if self.used[n] > self.capacity[n] + 1e-9}

    def held(self, job_id: str) -> Optional[dict[str, float]]:
        with self._lock:
            return dict(self._held[job_id]) if job_id in self._held else None

    def reservations(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {jid: dict(res) for jid, res in self._held.items()}

    def gang_reservations(self) -> dict[str, tuple[dict[str, float], int]]:
        """Live gang holds: {job_id: (per-pod charge, pod count)} — what
        the scheduler's shrink-to-k drain enumerates."""
        with self._lock:
            return {jid: (dict(pod), n)
                    for jid, (pod, n) in self._gangs.items()}

    # -- observability --------------------------------------------------
    def free(self) -> dict[str, float]:
        with self._lock:
            return {n: self.capacity[n] - self.used[n] for n in self.capacity}

    def utilization(self) -> dict[str, float]:
        """Per-dimension used/capacity. A zero-capacity dimension with
        live usage (a pool shrunk to nothing under running reservations)
        reports ``inf`` — a flagged over-commit, not a silent 0% — and
        never divides by zero."""
        with self._lock:
            out = {}
            for n in self.capacity:
                cap = self.capacity[n]
                if cap > 0:
                    out[n] = self.used[n] / cap
                else:
                    out[n] = float("inf") if self.used[n] > 1e-9 else 0.0
            return out

    def dominant_share(self, resources: Optional[dict[str, Any]]) -> float:
        """DRF-style dominant share of one job's charge — the fair-share
        accounting unit (usage = dominant_share x runtime)."""
        return self.dominant_share_charge(self.charge(resources))

    def dominant_share_charge(self, req: dict[str, float]) -> float:
        """Dominant share of an already-normalized charge (the scheduler
        settles with the reservation it released, which *is* a charge —
        re-normalizing it through ``charge()`` is an identity walk)."""
        shares = [amt / self.capacity[n] for n, amt in req.items()
                  if self.capacity.get(n, 0.0) > 0]
        return max(shares) if shares else 0.0
