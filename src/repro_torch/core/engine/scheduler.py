"""Cluster-capacity scheduler (ACAI §3.3.1–§3.3.2, scaled to shared
heterogeneous capacity).

A copy of ``repro/core/engine/scheduler.py``, with its imports
in ``repro_torch.core``.

The seed engine was a per-(project, user) FIFO with a quota of at most
``quota_k`` jobs in LAUNCHING|RUNNING per tuple. That quota survives, but
admission is now gated on finite capacity *pools* — one ``Cluster`` per
accelerator family, chosen per job by the ``Placement`` layer
(``core/engine/placement.py``): a job launches only when its resource
charge fits some eligible pool, reserved on launch and released on
terminal events. A single ``cluster=`` degenerates to one pool named
"default" (the homogeneous deployment); a job no pool can ever satisfy
fails fast at submit instead of queuing forever. Across queues the
scheduler orders work by

  1. priority      — queue priority + per-job priority, higher first;
  2. fair share    — accumulated dominant-share x runtime per queue,
                     divided by the queue's weight, lower first (DRF-style);
  3. submit order  — FIFO tie-break.

When the head candidate fits none of its pools, EASY backfill lets later
(smaller) jobs launch into the capacity hole as long as they provably do
not delay the blocked job *on its preferred pool*: either they finish
before the blocked job's shadow start time there (computed from that
pool's running jobs' expected completions), or they fit into the capacity
that remains spare on that pool after the blocked job starts. Shadow
state is per pool — a blocked head on the TPU pool never throttles CPU
dispatch, and a flexible job whose best pool is blocked simply takes its
next-ranked pool. With ``policy="fifo"`` the scheduler degrades to a
strict global-submission-order convoy (the benchmark baseline).

Dispatch is *incremental* (see docs/engine.md "Dispatch internals &
complexity"): the per-event hot path never rebuilds the world. Per-queue
candidate slices are cached sorted by ``(-priority, seq)`` and merged
lazily through a heap keyed by ``(-priority, decayed_share, seq)``, so a
pass only pays for the candidates it actually examines and only queues
whose contents/headroom changed re-sort. Queue deletion is tombstoned
(``kill``/launch are O(1) amortized instead of ``deque.remove``'s O(n)).
Per-pool EASY shadow state — the sorted expected-end list and the free
capacity it walks — is maintained incrementally on launch/terminal
instead of re-copying and re-sorting every reservation each round, and
the ``_min_charge`` saturation bound is a set of per-pool per-dimension
min-heaps over *live* queued charges (lazily pruned), so it tightens as
small jobs drain instead of going monotonically stale. Scheduler
snapshots are coalesced behind a change gate plus an optional
``snapshot_interval``. All of this is decision-preserving: the replay
equivalence tests assert bit-identical launch order and pool assignment
against traces recorded before the incremental core landed.

Dependency gating (the pipeline SDK's dataflow layer): a job whose
``spec.depends_on`` names unfinished parents is *held* — QUEUED in the
registry but absent from every dispatch queue, so it never enters the
candidate scan, the quota count, or the backfill shadow-time math. Parent
terminal events release it (all parents FINISHED -> enqueued) or cascade
it (any parent FAILED/KILLED -> terminal UPSTREAM_FAILED, published on the
bus so the cascade propagates transitively and handles/monitors wake).

Fair-share usage optionally decays with a configurable half-life
(``usage_halflife``, in runner-clock seconds) so past consumption stops
penalizing a queue forever.

Checkpoint-aware preemption (``preemption=True``, off by default so every
recorded decision trace replays bit-identically): when a queue head has
starved past ``starvation_threshold`` runner-clock seconds and fits no
pool, the scheduler preempts the lowest-priority / latest-started running
jobs whose released reservations provably unblock it — the launcher
delivers a checkpoint signal (``launcher.preempt``), fair-share settles
the victim's *actual partial runtime*, the reservation is released, and
the victim re-enters QUEUED (``RUNNING -> PREEMPTED -> QUEUED``) to
resume later from its last checkpoint. Each requeue bumps ``Job.epoch``;
terminal events stamped with an older epoch are dropped, so a superseded
incarnation can never settle (or double-release) the reservation of the
next one. The same preemption path drains a pool shrunk below its live
reservations (``resize_pool``) and models spot reclamations
(``reclaim``).

Dispatch is iterative and non-reentrant: runners that publish a terminal
``container_status`` synchronously from inside ``launch`` (instant local
jobs) re-enter the scheduler through the bus; a guard flag folds those
re-entries into the outer dispatch loop instead of recursing, so a fast job
can neither double-launch nor miscount quota/capacity. All entry points
are locked for the ThreadPoolRunner's worker threads.

The paper's 95 % profiling quorum (§4.2.2) stays a first-class
straggler-mitigation policy.
"""
from __future__ import annotations

import heapq
import inspect
import threading
import time
from bisect import bisect_left, insort
from collections import defaultdict, deque
from typing import Optional

from repro_torch.core.engine.cluster import CapacityError, Cluster
from repro_torch.core.engine.events import (EventBus, TOPIC_CONTAINER_STATUS,
                                            TOPIC_SCHEDULER)
from repro_torch.core.engine.lifecycle import (IllegalTransition,
                                               TERMINAL_STATES,
                                               TERMINAL_STATUS_VALUES,
                                               JobState)
from repro_torch.core.engine.placement import Placement
from repro_torch.core.engine.registry import Job, JobRegistry


def validate_spec(spec) -> None:
    """Reject malformed specs at submit, before any state change.

    Zero/negative resource dimensions silently fit every pool (a zero
    charge passes every capacity check), so a typo like ``{"tpu": 0}``
    would queue, launch, and hold nothing — fail loudly instead. Gang
    shapes are sanity-checked here too so a bad width/topology surfaces
    at submit rather than deep in admission.
    """
    shapes = [("resources", spec.resources or {})]
    for pool, res in (spec.pool_resources or {}).items():
        shapes.append((f"pool_resources[{pool!r}]", res or {}))
    gang = getattr(spec, "gang", None)
    if gang is not None and gang.per_pod_resources is not None:
        shapes.append(("gang.per_pod_resources", gang.per_pod_resources))
    for where, res in shapes:
        for dim, amt in res.items():
            if not isinstance(amt, (int, float)) or amt <= 0:
                raise ValueError(
                    f"job {spec.name!r}: {where} dimension {dim!r} must "
                    f"be a positive number, got {amt!r}")
    if gang is not None:
        if gang.n_pods < 1:
            raise ValueError(f"job {spec.name!r}: gang.n_pods must be "
                             f">= 1, got {gang.n_pods}")
        if not 0 <= gang.min_pods <= gang.n_pods:
            raise ValueError(
                f"job {spec.name!r}: gang.min_pods must be in "
                f"[0, n_pods={gang.n_pods}], got {gang.min_pods}")
        if gang.topology not in ("any", "close"):
            raise ValueError(f"job {spec.name!r}: gang.topology must be "
                             f"'any' or 'close', got {gang.topology!r}")
    retry = getattr(spec, "retry", None)
    if retry is not None:
        if retry.max_retries < 0:
            raise ValueError(f"job {spec.name!r}: retry.max_retries must "
                             f"be >= 0, got {retry.max_retries}")
        if retry.backoff_base < 0 or retry.backoff_cap < 0:
            raise ValueError(f"job {spec.name!r}: retry backoff must be "
                             f">= 0")
        if retry.retry_on not in ("transient", "any"):
            raise ValueError(f"job {spec.name!r}: retry.retry_on must be "
                             f"'transient' or 'any', got "
                             f"{retry.retry_on!r}")
    for knob in ("timeout_s", "deadline"):
        v = getattr(spec, knob, None)
        if v is not None and (not isinstance(v, (int, float)) or v <= 0):
            raise ValueError(f"job {spec.name!r}: {knob} must be a "
                             f"positive number of seconds, got {v!r}")


class QueueConfig:
    """Per-(project, user) scheduling knobs."""

    def __init__(self, priority: int = 0, weight: float = 1.0):
        self.priority = priority
        self.weight = max(weight, 1e-9)


class _Window:
    """A queue's candidate window, maintained incrementally.

    ``rows`` always holds the queue's first ``min(live, maxdepth)`` live
    jobs in arrival order as sort-keyed tuples (``(-priority, seq, jid,
    dispatch-records)`` under fair, ``(seq, jid, records)`` under fifo);
    jobs beyond it wait in the queue's tail deque and are promoted as the
    window drains, so a dispatch pass slices instead of rescanning the
    queue. ``fast`` means arrival order already equals candidate sort
    order (uniform priority, monotone seqs — the common case), making
    the slice the sorted window.

    ``agg``/``pdurs`` are the window-level rejection certificate (see
    ``_dispatch_once``). Minima are updated exactly on insert and left
    stale-but-conservative on removal (a too-small minimum only makes
    the certificate *less* willing to skip, never wrong); a full
    recompute runs every 64 mutations to restore tightness.
    """

    __slots__ = ("rows", "ids", "fast", "per_depth",
                 "muts", "stale", "agg", "pdurs", "pdur_of")

    def __init__(self):
        self.rows: list = []
        self.ids: set = set()
        self.fast = True
        self.per_depth: Optional[dict] = None
        self.muts = 0
        self.stale = False
        # per-pool window certificate: {pool: [per-dim minimum charge,
        # minimum expected duration, unprobed count, live member count]}
        # — when a pool is blocked and both backfill paths are provably
        # dead for every member, candidates eligible only there reject
        # wholesale. Durations fold in eagerly only when declared
        # statically (oracle draws must stay at the launcher's own probe
        # points); unknown estimates keep duration certificates off via
        # the unprobed count, and member counts drop a pool the moment
        # no live member references it. None = voided (unknown member).
        self.agg: Optional[dict] = {}
        # per-pool duration index: {pool: [(dur, -prio, seq, jid, recs)]}
        # sorted by dur, so a spare-dead pass enumerates only the
        # candidates that could still backfill by finishing early
        self.pdurs: dict = {}
        self.pdur_of: dict = {}


class Scheduler:
    def __init__(self, registry: JobRegistry, launcher, bus: EventBus,
                 quota_k: int = 2, *, cluster: Optional[Cluster] = None,
                 placement: Optional[Placement] = None,
                 policy: str = "fair", backfill: bool = True,
                 backfill_depth: int = 100,
                 usage_halflife: Optional[float] = None,
                 snapshot_interval: float = 0.0,
                 preemption: bool = False,
                 starvation_threshold: float = 300.0,
                 quarantine_threshold: int = 3,
                 user_failure_budget: Optional[int] = None):
        if policy not in ("fair", "fifo"):
            raise ValueError(f"unknown policy {policy!r}")
        if cluster is not None and placement is not None:
            raise ValueError("pass cluster= or placement=, not both")
        self.registry = registry
        self.launcher = launcher
        self.bus = bus
        self.quota_k = quota_k
        self.policy = policy
        self.backfill = backfill and policy == "fair"
        self.backfill_depth = backfill_depth
        self.usage_halflife = usage_halflife
        # checkpoint-aware preemption: off by default (decision traces
        # recorded without it must replay bit-identically), and only
        # meaningful when the launcher can deliver a checkpoint signal
        self.preemption = preemption
        self.starvation_threshold = starvation_threshold
        # fault tolerance (all inert unless some spec opts in): a job
        # whose spec carries a RetryPolicy re-queues FAILED incarnations
        # (epoch rebirth) after an exponential backoff hold; K
        # *consecutive* non-transient failures end it QUARANTINED (a
        # crash loop is a bug, not bad luck); a per-(project, user)
        # budget of non-transient failures-without-a-success stops a
        # crash-looping sweep from monopolizing dispatch with retries
        self.quarantine_threshold = quarantine_threshold
        self.user_failure_budget = user_failure_budget
        # backoff holds: job_id -> release time. QUEUED in the registry
        # but absent from every dispatch queue (like dependency holds),
        # released into _enqueue by the timer sweep at dispatch entry.
        self._backoff: dict[str, float] = {}
        # deadline/timeout enforcement points: a min-heap of
        # (fire_at, kind 0=timeout|1=deadline, job_id, epoch) — timeout
        # entries are per-incarnation (stale epochs skipped), deadline
        # entries absolute from submit (epoch -1, any incarnation)
        self._timers: list[tuple] = []
        self._ticking = False
        # wall-clock alarm for real-clock engines (no launcher.now):
        # nothing external calls tick() there, so the earliest pending
        # backoff release / deadline / timeout arms a daemon timer
        self._wall_alarm: Optional[threading.Timer] = None
        self._wall_alarm_at = 0.0
        # non-transient failures per queue key since its last success
        self._user_fails: dict[tuple, int] = defaultdict(int)
        self._can_preempt = callable(getattr(launcher, "preempt", None))
        self._can_forget = callable(getattr(launcher, "forget", None))
        self._preempting = False
        # snapshot coalescing: 0.0 publishes on every state change; > 0
        # rate-limits to one snapshot per interval of runner-clock seconds
        self.snapshot_interval = snapshot_interval
        self._queues: dict[tuple, deque[str]] = defaultdict(deque)
        self._active: dict[tuple, set[str]] = defaultdict(set)
        self._qconf: dict[tuple, QueueConfig] = defaultdict(QueueConfig)
        self._usage: dict[tuple, float] = defaultdict(float)
        self._usage_t: dict[tuple, float] = {}
        # dependency gating: held job -> unmet parent ids, and the reverse
        # index parent -> held children released/cascaded on its terminal
        self._held: dict[str, set[str]] = {}
        self._dependents: dict[str, set[str]] = defaultdict(set)
        self._seq_of: dict[str, int] = {}
        self._seq = 0
        # -- incremental dispatch state --------------------------------
        # tombstoned queues: _queued_set holds the ids that are *live*;
        # deque entries absent from it are tombstones skipped (and
        # compacted) lazily, making launch/kill removal O(1) amortized
        self._queued_set: set[str] = set()
        self._qlen: dict[tuple, int] = {}          # live length per queue
        self._tombs: dict[tuple, int] = {}         # tombstones per queue
        # per-queue candidate windows (see _Window): the first
        # quota_k + backfill_depth live jobs stay materialized in sort
        # order and mutate incrementally; _queues holds only each
        # queue's tail beyond its window
        self._qwin: dict[tuple, _Window] = {}
        # per-job dispatch-scan caches
        self._prio_of: dict[str, int] = {}
        self._opts_of: dict[str, dict] = {}       # job -> {pool: PoolOption}
        self._rank_of: dict[str, list[str]] = {}  # job -> pools best-first
        self._job_of: dict[str, Job] = {}         # skip registry lock
        # pre-flattened per-job dispatch records in rank order:
        # [pool, pool.used, ((dim, amt, cap+eps), ...), charge.items(),
        #  charge, memoized-expected-duration] — everything the admission
        # hot loop touches, resolved once per job instead of per visit
        self._dinfo: dict[str, list] = {}
        self._dur_takes_pool: Optional[bool] = None
        # submit fast path: when nothing changed since the last completed
        # (and therefore futile-ending) dispatch except new arrivals, and
        # none of them fits any of its pools right now (plus the blocked
        # registration certificate below), a full scan provably launches
        # nothing and is skipped entirely
        self._dirty_full = True
        self._new_cands: list[str] = []
        # futile-pass certificate: {pool: sort key of the candidate that
        # registered its blocked entry} plus how many candidates fit some
        # pool but were backfill-rejected; None = no valid certificate
        self._futile_blocked: Optional[dict] = None
        self._futile_fit_rejects = 0
        # saturation bound: pool -> dim -> min-heap of (charge, jid) over
        # live queued jobs, pruned lazily — replaces the old write-only
        # monotone _min_charge dict, so the bound tightens on settle
        self._min_charge: dict[str, dict[str, list]] = {}
        # per-pool EASY shadow state, maintained on launch/terminal:
        # sorted [(end, launch_seq, jid, reservation)], plus the count of
        # running jobs whose end the launcher could not estimate (any > 0
        # disables backfill on that pool, as the full rescan used to)
        self._pool_ends: dict[str, list] = {}
        self._end_key: dict[str, tuple] = {}      # jid -> (pool, sort key)
        self._unknown_ends: dict[str, int] = {}
        self._lseq = 0
        self._has_end = callable(getattr(launcher, "expected_end", None))
        self._has_dur = callable(getattr(launcher, "expected_duration",
                                         None))
        self._queued_at: dict[str, float] = {}
        self._started_at: dict[str, float] = {}
        self._lock = threading.RLock()
        self._dispatching = False
        self._dispatch_pending = False
        # snapshot gate: publish only when the revision moved (and the
        # interval elapsed); every state mutation bumps _state_rev
        self._state_rev = 0
        self._pub_rev = -1
        self._pub_t = float("-inf")
        self._settles = 0
        # running aggregates (not per-job lists): a long-lived platform
        # schedules millions of jobs, so metrics must stay O(queues)
        self.stats = {"launched": 0, "completed": 0, "backfilled": 0,
                      "wait_count": 0, "wait_sum": 0.0,
                      "wait_by_key": defaultdict(lambda: [0, 0.0]),
                      "placed_by_pool": defaultdict(int),
                      "snapshots": 0, "snapshots_skipped": 0,
                      "preempted": 0, "reclaimed": 0, "drained": 0,
                      "gang_shrunk": 0, "retried": 0, "quarantined": 0,
                      "timeouts": 0, "deadline_kills": 0,
                      "node_failures": 0, "retry_wasted_s": 0.0}
        self.placement: Optional[Placement] = None
        if placement is not None:
            self.placement = placement
        elif cluster is not None:
            self.placement = Placement({cluster.name or "default": cluster})
        # optional write-ahead journal (durable control plane): elastic
        # capacity changes record through it so a restarted engine
        # rebuilds the *current* pool sizes, not the boot-time ones
        self.journal = None
        bus.subscribe(TOPIC_CONTAINER_STATUS, self._on_container_status)

    # -- pools ----------------------------------------------------------
    @property
    def pools(self) -> dict[str, Cluster]:
        return self.placement.pools if self.placement is not None else {}

    @property
    def cluster(self) -> Optional[Cluster]:
        """The sole pool's cluster in a homogeneous deployment (legacy
        single-cluster callers); None when capacity-unconstrained or
        genuinely multi-pool."""
        pools = self.pools
        if len(pools) == 1:
            return next(iter(pools.values()))
        return None

    @cluster.setter
    def cluster(self, cl: Optional[Cluster]) -> None:
        with self._lock:
            self.placement = None if cl is None else \
                Placement({cl.name or "default": cl})
            # the pool set changed: every cached eligibility/ranking is
            # stale (they name pools that may no longer exist) — drop
            # them; _ensure_opts re-derives lazily per job. Shadow state
            # and the saturation bound belong to the old pools too; jobs
            # still running there release against the old Cluster object
            # (settle guards make the removal a no-op).
            self._min_charge = {}
            self._opts_of = {}
            self._rank_of = {}
            self._dinfo = {}
            self._pool_ends = {}
            self._end_key = {}
            self._unknown_ends = {}
            for w in self._qwin.values():
                w.stale = True      # window certificates name old pools
            self._dirty_full = True
            self._state_rev += 1

    # -- elasticity ------------------------------------------------------
    def resize_pool(self, pool: str, capacity: dict[str, float], *,
                    drain: bool = True) -> dict[str, float]:
        """Grow or shrink a pool's capacity (the provisioning loop's
        actuator). Per-job placement caches bake capacity thresholds and
        eligibility, so they are dropped and re-derived lazily; window
        rejection certificates are refreshed the same way. Reservations
        that outlive a shrink are drained through the preemption path
        (lowest-priority, latest-started first) when the launcher
        supports it — otherwise they simply finish naturally while the
        over-committed pool admits nothing new. Returns the immediate
        post-resize overage per dimension (before any drain completes).
        """
        with self._lock:
            cl = self.pools[pool]
            old_cap = dict(cl.capacity)
            overage = cl.resize(capacity)
            if self.journal is not None:
                # journal the full post-resize capacity (absolute, so
                # replay is idempotent even across partial-dim resizes)
                self.journal.pool_resized(pool, cl.capacity)
            grew = any(float(v) > old_cap.get(n, 0.0) + 1e-9
                       for n, v in capacity.items())
            if grew:
                # growth can make jobs eligible on this pool that were
                # not before (their caches do not reference it, so a
                # scoped drop would miss them): drop everything. Note
                # jobs already FAILED infeasible at submit are *not*
                # resurrected — declare shapes within the pool's floor
                # capacity, or submit after growing.
                self._opts_of = {}
                self._rank_of = {}
                self._dinfo = {}
            else:
                # shrink only narrows eligibility/thresholds of jobs
                # that reference this pool: a scoped drop is complete,
                # and the routine elastic control path stays cheap
                stale = [jid for jid, opts in self._opts_of.items()
                         if pool in opts]
                for jid in stale:
                    self._opts_of.pop(jid, None)
                    self._rank_of.pop(jid, None)
                    self._dinfo.pop(jid, None)
            for w in self._qwin.values():
                w.stale = True      # certificates embed old thresholds
            self._futile_blocked = None
            self._dirty_full = True
            self._state_rev += 1
            if overage and drain:
                # elastic gangs shrink to min_pods in place first — a
                # resize beats a full requeue (the trainer re-meshes from
                # its checkpoint without losing its slot)
                need = dict(overage)
                self._shrink_to_cover(cl, need)
                overage = {n: cl.used.get(n, 0.0) - cl.capacity.get(n, 0.0)
                           for n in overage
                           if cl.used.get(n, 0.0) >
                           cl.capacity.get(n, 0.0) + 1e-9}
            if overage and drain and self._can_preempt:
                # drain through the one victim-selection policy (lowest
                # priority, latest started), best-effort: even if no
                # victim set fully covers the overage, preempt what helps
                vics = self._pick_victims(cl, dict(overage), partial=True)
                over = lambda: any(
                    cl.used.get(n, 0.0) > cl.capacity.get(n, 0.0) + 1e-9
                    for n in capacity)
                was = self._preempting
                self._preempting = True     # batch: one dispatch at the end
                try:
                    for vid in vics or ():
                        if not over():
                            break
                        if self.preempt(vid):
                            self.stats["drained"] += 1
                finally:
                    self._preempting = was
            self._dispatch()
            return overage

    def reclaim(self, pool: str,
                capacity: Optional[dict[str, float]] = None, *,
                warning: float = 0.0) -> list[str]:
        """Forced preemption on a (spot) pool — the cloud took the nodes
        back. Frees at least ``capacity`` on every listed dimension
        (None = evict everything running there) by first shrinking
        resizable gangs to their floor, then preempting victims in the
        one shared victim order (lowest priority, latest started —
        ``_pick_victims``); they checkpoint and re-queue like any
        preemption. ``warning > 0`` models the cloud's advance notice: a
        checkpoint request (``launcher.request_checkpoint``) fires for
        every victim before the forced preempt lands, banking exact
        progress so the work lost to the reclaim is (near) zero instead
        of up to one checkpoint interval. Returns the preempted job ids
        (shrunk gangs keep running and are not listed)."""
        with self._lock:
            cl = self.pools.get(pool)
            if cl is None or not self._can_preempt:
                return []
            if capacity is None:
                # evict all: the need is everything currently reserved
                need: dict[str, float] = defaultdict(float)
                for res in cl.reservations().values():
                    for n, amt in res.items():
                        need[n] += amt
            else:
                free = cl.free()
                need = {n: amt - free.get(n, 0.0)
                        for n, amt in capacity.items()
                        if amt > free.get(n, 0.0) + 1e-9}
                if need:
                    # a partial reclaim is elastic pressure: resizable
                    # gangs give back pods in place before anyone is
                    # evicted (a full reclaim must evict regardless)
                    self._shrink_to_cover(cl, need)
            if not need:
                return []           # already free: nothing to evict
            victims = self._pick_victims(cl, dict(need), partial=True)
            req_ckpt = getattr(self.launcher, "request_checkpoint", None) \
                if warning > 0 else None
            if callable(req_ckpt):
                # the grace window: checkpoint requests land first, the
                # forced preemption only after — lost work ~ 0
                for vid in victims or ():
                    vjob = self._job_of.get(vid)
                    if vjob is not None:
                        req_ckpt(vjob)
            out = []
            was = self._preempting
            self._preempting = True         # batch: one dispatch at the end
            try:
                for vid in victims or ():
                    if self.preempt(vid):
                        out.append(vid)
            finally:
                self._preempting = was
            self.stats["reclaimed"] += len(out)
            if out:
                self._dispatch()
            return out

    # -- elastic gang resize (shrink-to-k) ------------------------------
    def shrink_gang(self, job_id: str, k: int) -> bool:
        """Shrink a RUNNING resizable gang to ``k`` pods in place: the
        surplus pods' reservation frees immediately, the launcher
        re-paces the remaining work at the new width, and the job's
        ``gang_pods`` drops so an in-process trainer can re-mesh from its
        checkpoint (``train.fault.gang_resize_hook``) — no requeue, no
        epoch bump. Returns False when the job is not a running gang or
        ``k`` is outside [max(1, min_pods), n_pods)."""
        with self._lock:
            job = self._job_of.get(job_id)
            if job is None:
                try:
                    job = self.registry.get(job_id)
                except KeyError:
                    return False
            if job.state != JobState.RUNNING or not job.pool:
                return False
            cl = self.pools.get(job.pool)
            g = cl.gang_of(job_id) if cl is not None and \
                hasattr(cl, "gang_of") else None
            if g is None:
                return False
            _pod, n = g
            gang = getattr(job.spec, "gang", None)
            floor = max(1, gang.min_pods if gang is not None else 0)
            if gang is None or gang.min_pods <= 0 or not floor <= k < n:
                return False
            cl.shrink_gang_hold(job_id, k)
            # re-pace BEFORE dropping the job's width: the launcher reads
            # the old width off the job to stretch the remaining work
            # (and to bill the elapsed segment at what it actually used)
            resize = getattr(self.launcher, "resize_gang", None)
            new_end = resize(job, k) if callable(resize) else None
            job.gang_pods = k
            # the shadow entry carries the old aggregate + old end: swap
            # it for the shrunk reservation at the re-paced completion
            self._drop_shadow(job_id)
            if job_id in self._started_at:
                if new_end is None:
                    self._unknown_ends[job.pool] = \
                        self._unknown_ends.get(job.pool, 0) + 1
                    self._end_key[job_id] = (job.pool, None)
                else:
                    self._lseq += 1
                    insort(self._pool_ends.setdefault(job.pool, []),
                           (new_end, self._lseq, job_id, cl.held(job_id)))
                    self._end_key[job_id] = (job.pool,
                                             (new_end, self._lseq))
            self.stats["gang_shrunk"] += 1
            self._dirty_full = True
            self._futile_blocked = None
            self._state_rev += 1
            return True

    def _shrink_to_cover(self, cl, need: dict[str, float]) -> list[str]:
        """Cover (part of) ``need`` by shrinking resizable running gangs
        toward their ``min_pods`` floor — tried before any preemption, in
        the same victim order (lowest effective priority, latest
        started). Mutates ``need`` in place; returns the resized ids."""
        gangs = getattr(cl, "gang_reservations", None)
        if gangs is None or not need:
            return []
        cands = []
        for vid, (pod, n) in gangs().items():
            vjob = self._job_of.get(vid)
            if vjob is None or vjob.state != JobState.RUNNING:
                continue
            gang = getattr(vjob.spec, "gang", None)
            if gang is None or gang.min_pods <= 0:
                continue
            floor = max(1, gang.min_pods)
            if n <= floor:
                continue
            vprio = self._qconf[vjob.queue_key].priority + \
                self._prio_of.get(vid, 0)
            cands.append((vprio, -self._started_at.get(vid, 0.0),
                          vid, pod, n, floor))
        cands.sort()
        shrunk = []
        for _, _, vid, pod, n, floor in cands:
            if not need:
                break
            want = 0            # pods whose release covers the shortfall
            for dim, amt in need.items():
                per = pod.get(dim, 0.0)
                if per > 1e-12:
                    want = max(want, int(-(-amt // per)))
            if want <= 0:
                continue        # this gang's pods carry none of the dims
            drop = min(want, n - floor)
            if drop <= 0 or not self.shrink_gang(vid, n - drop):
                continue
            shrunk.append(vid)
            for dim in list(need):
                left = need[dim] - pod.get(dim, 0.0) * drop
                if left <= 1e-9:
                    del need[dim]
                else:
                    need[dim] = left
        return shrunk

    def queued_demand(self, pool: str) -> int:
        """Live queued jobs eligible on ``pool`` — the provisioning
        controller's pressure signal. Jobs whose eligibility cache was
        dropped (a resize just happened) count conservatively as demand."""
        with self._lock:
            n = 0
            for jid in self._queued_set:
                opts = self._opts_of.get(jid)
                if opts is None or pool in opts:
                    n += 1
            return n

    # ------------------------------------------------------------------
    def _now(self) -> float:
        now = getattr(self.launcher, "now", None)
        return now if now is not None else time.time()

    def configure_queue(self, project: str, user: str, *,
                        priority: int = 0, weight: float = 1.0) -> None:
        with self._lock:
            self._qconf[(project, user)] = QueueConfig(priority, weight)
            w = self._qwin.get((project, user))
            if w is not None:
                w.stale = True      # row priorities embed the old config
            self._dirty_full = True

    # ------------------------------------------------------------------
    def submit(self, job: Job) -> None:
        validate_spec(job.spec)
        with self._lock:
            # resolve (and validate) dependencies before any state change:
            # an unknown parent id must not leave a zombie QUEUED job
            unmet, failed_parent = self._resolve_deps(job)
            self.registry.set_state(job.job_id, JobState.QUEUED)
            self._seq += 1
            self._seq_of[job.job_id] = self._seq
            self._prio_of[job.job_id] = job.spec.priority
            self._queued_at[job.job_id] = self._now()
            if failed_parent is not None:
                self._upstream_fail(job.job_id, failed_parent)
                return
            dl = getattr(job.spec, "deadline", None)
            if dl is not None:
                # fail-fast at admission when the deadline is *provably*
                # infeasible on every pool: the declared duration is a
                # pool-independent lower bound on wall time (retries and
                # checkpoint resumes only add to it), so duration >
                # deadline can never finish in time anywhere
                if job.spec.duration is not None and job.spec.duration > dl:
                    self._fail_infeasible(
                        job, err=(f"deadline {dl}s is infeasible: declared "
                                  f"duration {job.spec.duration}s exceeds "
                                  f"it on every pool"))
                    return
                heapq.heappush(self._timers,
                               (self._queued_at[job.job_id] + dl, 1,
                                job.job_id, -1))
            if self.placement is not None:
                options = self.placement.eligible(job.spec)
                if not options:
                    # no pool can ever fit it: fail fast, don't queue forever
                    self._fail_infeasible(job)
                    return
                self._opts_of[job.job_id] = options
            if unmet:
                # held: not in any queue, so invisible to the candidate
                # scan, the quota count and the backfill shadow-time math
                self._held[job.job_id] = unmet
                for pid in unmet:
                    self._dependents[pid].add(job.job_id)
                self._state_rev += 1
            else:
                self._enqueue(job)
            self._dispatch()

    def adopt_running(self, job: Job) -> None:
        """Re-attach a job whose run survived an engine crash (its
        process-boundary worker kept executing): rebuild the bookkeeping
        ``_launch`` would have created — quota membership, reservation,
        wait clocks, shadow state — without re-launching. The expected
        end is unknown (the original estimate died with the old engine),
        so the pool's backfill conservatively disables until it settles.
        """
        with self._lock:
            jid = job.job_id
            key = job.queue_key
            self._seq += 1
            self._seq_of[jid] = self._seq
            self._prio_of[jid] = job.spec.priority
            self._job_of[jid] = job
            self._active[key].add(jid)
            self._started_at[jid] = self._now()
            # privileged reassignment: the job's true state is externally
            # known (its worker is still executing), not derived by an
            # edge — the registry journals it like any transition
            self.registry.force_state(jid, JobState.RUNNING)
            if job.pool is not None:
                cl = self.pools.get(job.pool)
                if cl is None:
                    job.pool = None
                else:
                    try:
                        cl.reserve(jid, job.spec.resources)
                    except CapacityError:
                        # the pool shrank across the restart and the
                        # adopted set no longer fits: run it unreserved
                        # (pool=None, so settle releases nothing) rather
                        # than kill work that is already executing
                        job.pool = None
                    except Exception:
                        cl.release(jid)
                        raise
            if job.pool is not None:
                self._unknown_ends[job.pool] = \
                    self._unknown_ends.get(job.pool, 0) + 1
                self._end_key[jid] = (job.pool, None)
            self._dirty_full = True
            self._state_rev += 1

    _MISS = object()        # "duration not probed yet" sentinel

    def _ensure_opts(self, job: Job) -> dict:
        """The job's cached pool options, re-deriving (and re-ranking)
        them when the pool set changed since submit (legacy ``cluster=``
        reassignment drops the caches). Empty => nothing fits anymore."""
        opts = self._opts_of.get(job.job_id)
        if opts is None:
            opts = self.placement.eligible(job.spec)
            if opts:
                self._opts_of[job.job_id] = opts
                self._rank_of[job.job_id] = self.placement.rank(
                    job.spec, opts, parent_pools=self._parent_pools(job))
                self._build_dinfo(job.job_id)
                if job.job_id in self._queued_set:
                    self._push_min_charge(job.job_id, opts)
        return opts

    def _build_dinfo(self, job_id: str) -> None:
        """Flatten the job's ranked pool options into the records the
        admission loop iterates: per pool, the live ``used`` dict and
        pre-resolved ``(dim, amount, capacity + eps)`` fit thresholds
        (capacity is immutable, so the epsilon addition happens once per
        job instead of once per candidate visit), the charge item tuple
        the backfill spare check walks, a memoized runtime slot, and —
        only for a gang headed at a node-shaped pool — the (per-pod
        shape, pod count) the packability check needs (None everywhere
        else, so the non-gang hot path pays one ``is None`` test)."""
        opts = self._opts_of[job_id]
        pools = self.pools
        recs = []
        for pname in self._rank_of[job_id]:
            opt = opts[pname]
            cl = pools[pname]
            cap = cl.capacity
            gang = (opt.resources, opt.pods) if opt.pods > 1 and \
                getattr(cl, "node_shape", None) is not None else None
            recs.append([pname, cl.used,
                         tuple((n, amt, cap.get(n, 0.0) + 1e-9)
                               for n, amt in opt.charge.items()),
                         tuple(opt.charge.items()), opt.charge, self._MISS,
                         gang])
        self._dinfo[job_id] = recs

    def _push_min_charge(self, job_id: str, opts: dict) -> None:
        """Feed a live queued job's charges into the per-pool per-dim
        saturation heaps; entries are pruned lazily once the job leaves
        the queues (launched / killed / settled)."""
        for pname, opt in opts.items():
            heaps = self._min_charge.setdefault(pname, {})
            for n, amt in opt.charge.items():
                heapq.heappush(heaps.setdefault(n, []), (amt, job_id))

    def _enqueue(self, job: Job) -> None:
        """Queue a dispatchable job, ranking its eligible pools now — all
        parents are terminal at this point, so dataflow locality (the
        pools holding the parents' output filesets) is known."""
        if self.placement is not None:
            opts = self._ensure_opts(job)
            if not opts:
                self._fail_infeasible(job)
                return              # became infeasible (pool set changed)
            self._rank_of[job.job_id] = self.placement.rank(
                job.spec, opts, parent_pools=self._parent_pools(job))
            self._build_dinfo(job.job_id)
        jid = job.job_id
        key = job.queue_key
        self._queued_set.add(jid)
        self._qlen[key] = self._qlen.get(key, 0) + 1
        self._job_of[jid] = job
        w = self._qwin.get(key)
        if w is None:
            w = self._qwin[key] = _Window()
        if w.stale:
            self._win_refresh(key, w)
        if len(w.rows) < self._maxdepth():
            # normally the tail is empty here (promotion refills the
            # window on every removal); promote defensively in case
            # quota/backfill knobs grew the window since
            self._win_promote(key, w)
            if len(w.rows) < self._maxdepth():
                self._win_append(key, w, jid)
            else:
                self._queues[key].append(jid)
        else:
            self._queues[key].append(jid)       # beyond the window: tail
        self._new_cands.append(jid)
        if self.placement is not None:
            self._push_min_charge(jid, self._opts_of[jid])
        self._state_rev += 1

    def _maxdepth(self) -> int:
        """Window capacity: the deepest any pass can scan one queue."""
        return self.quota_k + (self.backfill_depth if self.backfill else 0)

    def _remove_queued(self, key: tuple, job_id: str) -> None:
        """Remove a job from its queue: an O(window) in-place delete plus
        tail promotion when it sat in the candidate window (the common
        case — launches come from the window), an O(1) tombstone in the
        tail deque otherwise (compacted once the dead outnumber the
        living)."""
        self._queued_set.discard(job_id)
        self._qlen[key] -= 1
        w = self._qwin.get(key)
        if w is not None and job_id in w.ids:
            w.ids.discard(job_id)
            rows = w.rows
            jpos = 2 if self.policy != "fifo" else 1
            removed = None
            for i, row in enumerate(rows):
                if row[jpos] == job_id:
                    removed = row
                    del rows[i]
                    break
            w.per_depth = None
            if w.agg is not None and removed is not None and \
                    removed[jpos + 1] is not None:
                # exact per-pool member counts: a pool no live member is
                # eligible for must stop gating the window certificate
                # (its minima would otherwise suppress skips forever)
                for r in removed[jpos + 1]:
                    ent = w.agg.get(r[0])
                    if ent is not None:
                        ent[3] -= 1
                        if r[5] is self._MISS and ent[2] > 0:
                            ent[2] -= 1
                        if ent[3] <= 0:
                            del w.agg[r[0]]
            dkeys = w.pdur_of.pop(job_id, None)
            if dkeys:
                for pname, dkey in dkeys.items():
                    lst_d = w.pdurs.get(pname)
                    if lst_d:
                        di = bisect_left(lst_d, dkey)
                        if di < len(lst_d) and lst_d[di][3] == job_id:
                            lst_d.pop(di)
            w.muts += 1         # removals only: they stale the minima
            if w.muts >= 64:
                w.stale = True      # restore certificate tightness
            self._win_promote(key, w)
        else:
            tombs = self._tombs.get(key, 0) + 1
            if tombs > 8 and tombs > self._qlen[key]:
                live = self._queued_set
                self._queues[key] = deque(
                    j for j in self._queues[key] if j in live)
                tombs = 0
            self._tombs[key] = tombs
        self._state_rev += 1

    def _win_promote(self, key: tuple, w: _Window) -> None:
        """Refill the window from the queue's tail (skipping tombstones)
        so it again holds the first ``min(live, maxdepth)`` live jobs."""
        tail = self._queues.get(key)
        if not tail:
            return
        live = self._queued_set
        maxdepth = self._maxdepth()
        while len(w.rows) < maxdepth and tail:
            jid = tail.popleft()
            if jid in live:
                self._win_append(key, w, jid)
            else:
                self._tombs[key] = self._tombs.get(key, 0) - 1

    def _win_append(self, key: tuple, w: _Window, jid: str) -> None:
        """Append one job to the window, updating sort-order fastness and
        the single-pool rejection certificate incrementally (minima only
        ever tighten downward here — exact; removals leave them stale
        low, which is the conservative direction)."""
        seq = self._seq_of[jid]
        rows = w.rows
        recs = self._dinfo.get(jid)
        if self.policy == "fifo":
            if rows and rows[-1][0] > seq:
                w.fast = False
            rows.append((seq, jid, recs))
            w.ids.add(jid)
            w.per_depth = None
            return      # certificates are a fair-policy device
        np_ = -(self._qconf[key].priority + self._prio_of.get(jid, 0))
        if rows and (rows[-1][0] != np_ or rows[-1][1] > seq):
            w.fast = False
        rows.append((np_, seq, jid, recs))
        w.ids.add(jid)
        w.per_depth = None
        if recs is None:
            w.agg = None        # unknown member: certificates void
            return
        if w.agg is not None:
            # per-pool certificate minima over every pool any member is
            # eligible for (see the window skips in _dispatch_once).
            # Probe eagerly only when the duration is declared statically
            # (then every shipped launcher's estimate is a pure read);
            # oracle-backed estimates must be drawn at the launcher's own
            # probe points or the draw would see unpinned resources
            static_dur = self._job_of[jid].spec.duration is not None
            dkeys = None
            for r in recs:
                ent = w.agg.get(r[0])
                if ent is None:
                    ent = w.agg[r[0]] = [{}, None, 0, 0]
                ent[3] += 1         # live members eligible on this pool
                mins = ent[0]
                for nm, amt, thr in r[2]:
                    cur = mins.get(nm)
                    if cur is None or amt < cur[0]:
                        mins[nm] = (amt, thr)
                d = r[5]
                if d is self._MISS and static_dur:
                    d = self._probe_duration(jid, r[0])
                    r[5] = d
                if d is self._MISS:
                    ent[2] += 1     # unknown: duration certificates off
                elif d is not None:
                    if ent[1] is None or d < ent[1]:
                        ent[1] = d
                    dkey = (d, np_, seq)
                    insort(w.pdurs.setdefault(r[0], []),
                           dkey + (jid, recs))
                    if dkeys is None:
                        dkeys = {}
                    dkeys[r[0]] = dkey
            if dkeys is not None:
                w.pdur_of[jid] = dkeys

    def _win_refresh(self, key: tuple, w: _Window) -> None:
        """Full rebuild of a window's rows and certificate from its own
        job order (plus tail promotion): runs after config/pool changes
        and periodically to re-tighten removal-staled minima."""
        jpos = 2 if self.policy != "fifo" else 1
        jids = [row[jpos] for row in w.rows]
        w.rows = []
        w.ids = set()
        w.fast = True
        w.per_depth = None
        w.agg = {}
        w.pdurs = {}
        w.pdur_of = {}
        w.stale = False
        for jid in jids:
            self._win_append(key, w, jid)
        self._win_promote(key, w)
        w.muts = 0

    def _parent_pools(self, job: Job) -> set[str]:
        pools = set()
        for pid in job.spec.depends_on or ():
            try:
                parent = self.registry.get(pid)
            except KeyError:
                continue
            if parent.pool:
                pools.add(parent.pool)
        return pools

    def _resolve_deps(self, job: Job) -> tuple[set[str], Optional[str]]:
        """(unmet parent ids, first already-failed parent or None)."""
        unmet: set[str] = set()
        for pid in dict.fromkeys(job.spec.depends_on or ()):
            try:
                parent = self.registry.get(pid)
            except KeyError:
                raise ValueError(
                    f"{job.job_id} depends on unknown job {pid!r}") from None
            if parent.state == JobState.FINISHED:
                continue
            if parent.state in TERMINAL_STATES:
                return set(), pid
            unmet.add(pid)
        return unmet, None

    def kill(self, job_id: str) -> None:
        with self._lock:
            job = self.registry.get(job_id)
            if job.state in TERMINAL_STATES:
                return
            key = job.queue_key
            launched = job_id in self._started_at
            if job_id in self._queued_set:
                self._remove_queued(key, job_id)
            self._unhold(job_id)
            self._backoff.pop(job_id, None)
            self._active[key].discard(job_id)
            # epoch read + terminal write both happen under this lock
            # (every epoch bump is lock-ordered behind it), so the guard
            # pins "kill this incarnation" even against a racing retry
            self.registry.set_state(job_id, JobState.KILLED,
                                    expect_epoch=job.epoch)
            if launched:
                # the runner publishes the terminal event when the job
                # actually stops (virtual-clock pop / worker finalize);
                # settle capacity now so the slot frees immediately
                self._settle(job_id, key)
                self._dispatch()
            else:
                # never reached the runner: publish the terminal event
                # ourselves so handles, monitors and held dependents
                # observe the kill (the handler settles + dispatches)
                self.registry.persist_state(job_id)
                self.bus.publish(TOPIC_CONTAINER_STATUS,
                                 {"job_id": job_id, "status": "KILLED",
                                  "epoch": job.epoch})

    # -- checkpoint-aware preemption ------------------------------------
    def preempt(self, job_id: str) -> bool:
        """Revoke a RUNNING job's reservation and re-queue it to resume
        from its last checkpoint (``RUNNING -> PREEMPTED -> QUEUED``).

        Returns False — job untouched — only when it is not RUNNING or
        the launcher has no ``preempt`` capability. Otherwise the
        preemption commits *before* the checkpoint signal is delivered
        (state + epoch move first, so a cooperative worker observing the
        signal mid-delivery already sees it as real), and the delivery
        itself is best-effort: a worker that completed in the same
        instant loses the race and its terminal event is dropped as
        stale. Fair-share settles the *actual* partial runtime of the
        segment, the reservation is released exactly once (the epoch
        guard drops superseded incarnations' terminal events), and the
        job re-enters its queue with a fresh sequence number and wait
        clock.
        """
        with self._lock:
            try:
                job = self.registry.get(job_id)
            except KeyError:
                return False
            if job.state != JobState.RUNNING or not self._can_preempt:
                return False
            key = job.queue_key
            # transition + epoch bump BEFORE delivering the signal, and
            # atomically under the registry lock: a cooperative worker
            # that observes its flag mid-delivery must already see the
            # preemption as real (epoch moved), or it would misread the
            # raise as spurious and fail the job — and its own
            # epoch-guarded finalize write must serialize against the bump
            try:
                self.registry.mark_preempted(job_id)
            except IllegalTransition:
                # a worker finalized the job (RUNNING -> terminal, under
                # the registry lock alone) between our check and the
                # transition: the completion won — nothing to preempt
                return False
            # best-effort: a worker that completed in the same instant
            # loses the race — its terminal event (stamped with the old
            # epoch) is dropped and the job re-runs from its checkpoint
            self.launcher.preempt(job)
            self._active[key].discard(job_id)
            self._settle_preempted(job_id, key, job)
            self.stats["preempted"] += 1
            # re-queue for a fresh launch: new seq (the tail of its
            # queue), new wait clock; pool ranking re-derives at enqueue
            self.registry.set_state(job_id, JobState.QUEUED)
            self._seq += 1
            self._seq_of[job_id] = self._seq
            self._prio_of[job_id] = job.spec.priority
            self._queued_at[job_id] = self._now()
            self._enqueue(job)
            self._dirty_full = True
            if not self._preempting:
                self._dispatch()    # externally-driven preemption (spot
            return True             # reclaim): relaunch what now fits

    def _settle_preempted(self, job_id: str, key: tuple, job) -> None:
        """Release the preempted segment's reservation and charge
        fair-share with its actual partial runtime. Unlike ``_settle``
        the per-job caches survive — the job is still live and about to
        re-enter its queue."""
        pool_cl, released, started_at = self._release_segment(job_id, job)
        self._state_rev += 1
        if started_at is None:
            return
        self._charge_segment(key, job, pool_cl, released,
                             max(0.0, self._now() - started_at))

    def _release_segment(self, job_id: str, job) -> tuple:
        """Release the job's reservation and shadow-state entry — the
        half of settling shared by terminal settles and preemptions.
        Returns (pool cluster, released charge, started_at)."""
        pool_cl = self.pools.get(job.pool) if job.pool else None
        released = pool_cl.release(job_id) if pool_cl is not None else None
        started_at = self._started_at.pop(job_id, None)
        self._drop_shadow(job_id)
        self._dirty_full = True
        return pool_cl, released, started_at

    def _charge_segment(self, key: tuple, job, pool_cl, released,
                        runtime: float) -> None:
        """Fair-share charge for one runtime segment: the dominant share
        on the pool the job ran on (the released charge when available) —
        THE one formula for terminal and preemption settles alike."""
        if pool_cl is None:
            share = 1.0
        elif released is not None:
            share = pool_cl.dominant_share_charge(released)
        else:
            share = pool_cl.dominant_share(job.spec.resources)
        self._charge_usage(key, (share if share > 0 else 1.0) * runtime)

    def _run_preemption(self) -> bool:
        """One preemption round: find the starved head — the highest
        effective-priority live queue-head whose wait exceeds
        ``starvation_threshold`` and which fits no pool — then preempt
        the lowest-priority / latest-started running jobs whose released
        reservations cover its shortfall on some eligible pool (tried in
        the head's placement rank order). Returns True if victims were
        preempted (the caller re-dispatches)."""
        if self.placement is None:
            return False
        now = self._now()
        jpos = 2 if self.policy != "fifo" else 1
        head = None     # (-eff_priority, seq) of the best starved head
        for key, w in self._qwin.items():
            if self._qlen.get(key, 0) <= 0:
                continue
            if len(self._active[key]) >= self.quota_k:
                continue    # quota-pinned: a launch is impossible anyway
            if w.stale:
                self._win_refresh(key, w)
            # O(1) pre-filter: _queued_at is assigned in seq order, so
            # the first live row in arrival order holds the queue's
            # minimum wait clock — if IT is not starved, nobody here is,
            # and the sorted-candidate walk below is skipped entirely
            # (the common case on every dispatch under steady load)
            oldest_ok = False
            for row in w.rows:
                jid0 = row[jpos]
                if jid0 in self._queued_set:
                    oldest_ok = now - self._queued_at.get(jid0, now) >= \
                        self.starvation_threshold
                    break
            if not oldest_ok:
                continue
            # scan in candidate *sort* order, not arrival order: the
            # queue's policy head is its highest-priority live job, and a
            # starved high-priority job parked behind an older low-prio
            # one must not be hidden by it
            rows = w.rows if self.policy == "fifo" else \
                self._queue_cands(w, len(w.rows))
            for row in rows:
                jid = row[jpos]
                if jid not in self._queued_set:
                    continue
                # only queue heads are starvation candidates: deeper jobs
                # are behind them by policy order anyway
                if now - self._queued_at.get(jid, now) >= \
                        self.starvation_threshold:
                    eff = self._qconf[key].priority + \
                        self._prio_of.get(jid, 0)
                    cand = (-eff, self._seq_of.get(jid, 0), jid, key)
                    if head is None or cand < head:
                        head = cand
                break
        if head is None:
            return False
        neg_prio, _, jid, key = head
        head_prio = -neg_prio
        job = self._job_of[jid]
        recs = self._dinfo.get(jid)
        if recs is None:
            if not self._ensure_opts(job):
                return False
            recs = self._dinfo.get(jid)
            if recs is None:
                return False
        # a head that fits some pool right now is backfill/fairness
        # blocked, not capacity starved: preemption cannot help it
        for rec in recs:
            used_d = rec[1]
            if all(used_d.get(n, 0.0) + amt <= thr
                   for n, amt, thr in rec[2]) and self._packable(jid, rec):
                return False
        for pname in self._rank_of.get(jid, ()):
            cl = self.pools.get(pname)
            if cl is None:
                continue
            charge = self._opts_of[jid][pname].charge
            free = cl.free()
            need = {n: amt - free.get(n, 0.0) for n, amt in charge.items()
                    if amt > free.get(n, 0.0) + 1e-9}
            if not need:
                continue
            victims = self._pick_victims(cl, need, max_priority=head_prio)
            if victims is None:
                continue        # this pool cannot be unblocked: next
            for vid in victims:
                self.preempt(vid)
            return True
        return False

    def _pick_victims(self, cl, need: dict[str, float], *,
                      max_priority: Optional[int] = None,
                      partial: bool = False) -> Optional[list[str]]:
        """The minimal prefix of (lowest effective priority, latest
        started) RUNNING jobs on ``cl`` whose reservations cover every
        dimension of ``need``. When full coverage is impossible, returns
        None — or, with ``partial=True``, every eligible victim (the
        shrink-drain's best effort). ``max_priority`` (exclusive)
        protects equal-or-higher-priority work from being preempted for
        a starved head. This is THE victim-selection policy: starvation
        preemption, spot reclamation drains and pool-shrink drains must
        all pick identically."""
        cands = []
        for vid, res in cl.reservations().items():
            vjob = self._job_of.get(vid)
            if vjob is None or vjob.state != JobState.RUNNING:
                continue
            vprio = self._qconf[vjob.queue_key].priority + \
                self._prio_of.get(vid, 0)
            if max_priority is not None and vprio >= max_priority:
                continue
            cands.append((vprio, -self._started_at.get(vid, 0.0), vid, res))
        cands.sort()
        chosen: list[str] = []
        freed: dict[str, float] = defaultdict(float)
        for _, _, vid, res in cands:
            chosen.append(vid)
            for n, amt in res.items():
                freed[n] += amt
            if all(freed.get(n, 0.0) + 1e-9 >= amt
                   for n, amt in need.items()):
                return chosen
        return chosen if partial else None

    # -- fault tolerance -------------------------------------------------
    def tick(self) -> None:
        """Advance fault-tolerance time at the current runner clock:
        fire due deadline/timeout timers, release due backoff holds,
        then dispatch. Event loops that drive a virtual clock call this
        after every clock advance (terminal events dispatch anyway; this
        covers advances where nothing completed)."""
        with self._lock:
            self._dispatch()

    def next_timer(self) -> Optional[float]:
        """The earliest pending fault-tolerance enforcement point
        (deadline, timeout or backoff release), or None. Virtual-clock
        loops advance to ``min(next completion, next fault, next timer)``
        so backoff holds release and deadlines fire even while nothing
        is completing. May name an already-stale timer entry; firing it
        is a no-op but still makes progress (the entry pops)."""
        with self._lock:
            cands = []
            if self._timers:
                cands.append(self._timers[0][0])
            if self._backoff:
                cands.append(min(self._backoff.values()))
            return min(cands) if cands else None

    def _arm_wall_alarm(self) -> None:
        """Real-clock engines have no event loop calling ``tick()``, so
        a pending backoff hold or deadline/timeout would only fire when
        an unrelated event happened to dispatch: arm a daemon wall-clock
        timer for the earliest enforcement point instead. Virtual-clock
        runs (``launcher.now`` set) advance time themselves and never
        arm one — their traces stay bit-identical. Called at dispatch
        exit (every arming site ends in a dispatch), under the lock."""
        if getattr(self.launcher, "now", None) is not None:
            return
        due = None
        if self._timers:
            due = self._timers[0][0]
        if self._backoff:
            soonest = min(self._backoff.values())
            due = soonest if due is None else min(due, soonest)
        if due is None:
            return
        alarm = self._wall_alarm
        if (alarm is not None and alarm.is_alive()
                and self._wall_alarm_at <= due + 1e-9):
            return              # the armed alarm fires at or before due
        if alarm is not None:
            alarm.cancel()
        t = threading.Timer(max(0.0, due - time.time()),
                            lambda: self._wall_fire(t))
        t.daemon = True
        self._wall_alarm = t
        self._wall_alarm_at = due
        t.start()

    def _wall_fire(self, alarm: threading.Timer) -> None:
        with self._lock:
            if self._wall_alarm is alarm:
                self._wall_alarm = None
        self.tick()

    def _release_backoffs(self, now: float) -> None:
        """Move backoff holds whose release time arrived back into their
        dispatch queues (wait clock restarts at release — the hold is
        penance, not queueing)."""
        due = [jid for jid, t in self._backoff.items() if t <= now + 1e-9]
        for jid in sorted(due, key=lambda j: self._seq_of.get(j, 0)):
            del self._backoff[jid]
            job = self._job_of.get(jid)
            if job is None or job.state != JobState.QUEUED:
                continue        # killed while held (kill pops, but stay safe)
            self._queued_at[jid] = now
            self._enqueue(job)
            self._dirty_full = True
            self._futile_blocked = None

    def _fire_timers(self, now: float) -> None:
        """Enforce due deadline/timeout entries. A timeout fails the
        *incarnation* transient (straggler semantics — the retry budget
        may try it elsewhere); a deadline kills the *job* outright (the
        result is worthless after it, queued or running)."""
        while self._timers and self._timers[0][0] <= now + 1e-9:
            _t, kind, jid, epoch = heapq.heappop(self._timers)
            job = self._job_of.get(jid)
            if job is None:
                try:
                    job = self.registry.get(jid)
                except KeyError:
                    continue
            if job.state in TERMINAL_STATES:
                continue
            if kind == 0:       # per-incarnation timeout
                if job.state != JobState.RUNNING or job.epoch != epoch:
                    continue    # stale: that incarnation already ended
                err = (f"timeout: incarnation exceeded "
                       f"{job.spec.timeout_s}s")
                self.stats["timeouts"] += 1
                fr = getattr(self.launcher, "fail_running", None)
                if callable(fr) and fr(job, err, transient=True):
                    continue    # terminal event handler settles/retries
                self.kill(jid)
                job.error = err
            else:               # absolute deadline
                err = (f"deadline exceeded "
                       f"({job.spec.deadline}s after submit)")
                self._backoff.pop(jid, None)
                self.kill(jid)
                job.error = err
                self.stats["deadline_kills"] += 1

    def _maybe_retry(self, job: Job, key: tuple, msg: dict) -> bool:
        """Decide a FAILED incarnation's fate under the job's retry
        policy: requeue it as a new epoch (True — the caller skips the
        terminal settle and dependent cascade), quarantine a crash loop
        (False, with the registry state refined FAILED -> QUARANTINED so
        the caller settles it as the terminal it is), or let it stay
        FAILED (False). Inert unless the spec opted into a RetryPolicy —
        jobs without one take the exact pre-retry path, so recorded
        decision traces replay bit-identically."""
        policy = getattr(job.spec, "retry", None)
        if policy is None or job.state != JobState.FAILED:
            return False
        jid = job.job_id
        if jid not in self._started_at:
            return False        # never launched (infeasible submit):
                                # retrying can never change the outcome
        transient = bool(msg.get("transient"))
        streak = self.registry.note_failure(jid, transient)
        if not transient:
            self._user_fails[key] += 1
        if not transient and streak >= self.quarantine_threshold:
            # crash loop: the same non-transient failure K times in a row
            # is a bug, not bad luck — park it terminally instead of
            # burning the rest of the budget (FAILED -> QUARANTINED is
            # the transition table's one terminal-refinement edge)
            self.registry.set_state(
                jid, JobState.QUARANTINED,
                error=(f"quarantined after {streak} consecutive "
                       f"failures: {msg.get('error') or job.error}"),
                expect_epoch=job.epoch)
            self.registry.persist_state(jid)
            self.stats["quarantined"] += 1
            return False
        if not transient and policy.retry_on != "any":
            return False        # fatal failure, transient-only budget
        if job.retries >= policy.max_retries:
            return False        # budget exhausted: stays FAILED
        if self.user_failure_budget is not None and not transient and \
                self._user_fails[key] > self.user_failure_budget:
            return False        # the queue's failure budget is spent:
                                # stop feeding its crash loops dispatch
        # requeue as a fresh incarnation: settle the failed segment like
        # a preemption (release the reservation, charge fair-share for
        # the wasted runtime), then epoch-rebirth FAILED -> QUEUED
        now = self._now()
        started = self._started_at.get(jid)
        if started is not None:
            self.stats["retry_wasted_s"] += max(0.0, now - started)
        self._settle_preempted(jid, key, job)
        hold = policy.backoff(job.retries)      # pre-bump retry count
        self.registry.mark_retrying(jid)
        self.stats["retried"] += 1
        self._seq += 1
        self._seq_of[jid] = self._seq
        self._prio_of[jid] = job.spec.priority
        if hold > 0:
            self._backoff[jid] = now + hold
            self._state_rev += 1
        else:
            self._queued_at[jid] = now
            self._enqueue(job)
        self._dirty_full = True
        self._futile_blocked = None
        return True

    def fail_node(self, pool: str, node_idx: int) -> list[str]:
        """Kill one node on ``pool`` (the fault injector's actuator; on a
        real fleet, the health prober's). The node leaves packing and
        capacity, and every job holding a reservation on it fails
        atomically — a gang with one pod there fails whole, because the
        reservation is one unit. Node loss is *transient* (the
        infrastructure broke, not the job), so retry policies requeue
        the victims. Returns the job ids that were failed."""
        with self._lock:
            cl = self.pools[pool]
            residents = cl.fail_node(node_idx)
            self.stats["node_failures"] += 1
            return self._after_node_down(pool, residents, fail=True,
                                         node_idx=node_idx)

    def drain_node(self, pool: str, node_idx: int) -> list[str]:
        """Cordon one node on ``pool``: no new placements land on it,
        residents finish naturally. Returns the resident job ids."""
        with self._lock:
            cl = self.pools[pool]
            residents = cl.drain_node(node_idx)
            return self._after_node_down(pool, residents, fail=False,
                                         node_idx=node_idx)

    def _after_node_down(self, pool: str, residents: list[str], *,
                         fail: bool, node_idx: int) -> list[str]:
        """Shared tail of fail_node/drain_node: capacity shrank, so the
        per-job caches that bake this pool's thresholds are stale (same
        scoped drop resize_pool's shrink path does); on a hard failure
        the residents fail through the launcher so the terminal events
        flow the normal settle/retry path."""
        stale = [jid for jid, opts in self._opts_of.items() if pool in opts]
        for jid in stale:
            self._opts_of.pop(jid, None)
            self._rank_of.pop(jid, None)
            self._dinfo.pop(jid, None)
        for w in self._qwin.values():
            w.stale = True
        self._futile_blocked = None
        self._dirty_full = True
        self._state_rev += 1
        out = []
        if fail:
            fr = getattr(self.launcher, "fail_running", None)
            was = self._dispatching
            self._dispatching = True    # batch: one dispatch at the end
            try:
                for jid in residents:
                    job = self._job_of.get(jid)
                    if job is None or job.state != JobState.RUNNING:
                        continue
                    err = f"node {node_idx} on pool {pool} failed"
                    if callable(fr):
                        if fr(job, err, transient=True):
                            out.append(jid)
                    else:
                        self.kill(jid)
                        job.error = err
                        out.append(jid)
            finally:
                self._dispatching = was
        else:
            out = list(residents)
        self._dispatch()
        return out

    def _unhold(self, job_id: str) -> None:
        """Drop a held job's gating state: O(its parents), using the unmet
        set as the exact index into _dependents."""
        unmet = self._held.pop(job_id, None)
        for pid in unmet or ():
            deps = self._dependents.get(pid)
            if deps is not None:
                deps.discard(job_id)

    def _upstream_fail(self, job_id: str, parent_id: str) -> None:
        """Cascade-cancel a never-launched job whose parent did not
        finish; the published event propagates the cascade transitively."""
        job = self.registry.get(job_id)
        self.registry.set_state(
            job_id, JobState.UPSTREAM_FAILED,
            error=f"upstream job {parent_id} did not finish",
            expect_epoch=job.epoch)
        self.registry.persist_state(job_id)
        self._state_rev += 1
        self.bus.publish(TOPIC_CONTAINER_STATUS,
                         {"job_id": job_id, "status": "UPSTREAM_FAILED",
                          "upstream": parent_id, "epoch": job.epoch})

    def _release_dependents(self, parent_id: str, status: str) -> None:
        """On a parent's terminal event: enqueue held children whose last
        parent FINISHED, cascade UPSTREAM_FAILED children otherwise."""
        children = self._dependents.pop(parent_id, None)
        if not children:
            return
        for cid in sorted(children):
            unmet = self._held.get(cid)
            if unmet is None:
                continue
            if status == JobState.FINISHED.value:
                unmet.discard(parent_id)
                if not unmet:
                    del self._held[cid]
                    child = self.registry.get(cid)
                    # queue wait starts at eligibility, not submit: the
                    # parent-hold time is dataflow latency, not queueing
                    self._queued_at[cid] = self._now()
                    self._enqueue(child)
            else:
                unmet.discard(parent_id)
                self._unhold(cid)
                self._upstream_fail(cid, parent_id)

    # -- dispatch (non-reentrant) ---------------------------------------
    def _maybe_launch(self, key: Optional[tuple] = None) -> None:
        """Back-compat alias for the dispatch loop."""
        with self._lock:
            self._dispatch()

    def _dispatch(self) -> None:
        if (self._timers or self._backoff) and not self._ticking:
            # fault-tolerance timers ride the dispatch entry point (every
            # clock advance ends in a dispatch): release due backoff
            # holds back into their queues and enforce due deadlines /
            # incarnation timeouts. Guarded non-reentrant — enforcement
            # kills/fails publish terminal events whose handlers dispatch.
            self._ticking = True
            try:
                now = self._now()
                if self._backoff:
                    self._release_backoffs(now)
                if self._timers:
                    self._fire_timers(now)
            finally:
                self._ticking = False
        if self._dispatching:
            # re-entered from a terminal event published inside launch();
            # fold into the outer loop instead of recursing.
            self._dispatch_pending = True
            return
        if not self._dirty_full and self._new_arrivals_unfit():
            # nothing changed since the last (futile-ending) full scan
            # except arrivals that fit no pool right now: a full pass
            # would reject every candidate again — skip it. Safe because
            # rejections are stable under pure arrivals: capacity only
            # changes on launch/terminal (which set _dirty_full), the
            # passage of time only *hardens* the backfill duration test,
            # and fair-share order changes cannot create admissions when
            # there are none to reorder.
            self._maybe_preempt()
            self._publish_snapshot()
            self._arm_wall_alarm()
            return
        self._dispatch_loop()
        self._maybe_preempt()
        self._publish_snapshot()
        self._arm_wall_alarm()

    def _dispatch_loop(self) -> None:
        self._dispatching = True
        try:
            progress = True
            while progress or self._dispatch_pending:
                self._dispatch_pending = False
                progress = self._dispatch_once()
            self._dirty_full = False
            del self._new_cands[:]
        finally:
            self._dispatching = False

    def _maybe_preempt(self) -> None:
        """Starvation-triggered preemption rounds after a dispatch pass:
        each round frees exactly the capacity one starved head needs,
        then re-runs dispatch so it (and anything else the releases
        unblocked) launches. Non-reentrant — the dispatches triggered by
        requeued victims fold into this round instead of recursing."""
        if not self.preemption or not self._can_preempt or self._preempting:
            return
        self._preempting = True
        try:
            while self._run_preemption():
                self._dispatch_loop()
        finally:
            self._preempting = False

    def _new_arrivals_unfit(self) -> bool:
        """True when skipping a full dispatch pass is provably
        decision-identical to running it: every not-yet-scanned arrival
        (a) fails the capacity fit check on all of its pools, and (b)
        cannot perturb the blocked-entry registrations old fit-but-
        backfill-rejected candidates were judged against — either no such
        candidate exists (``_futile_fit_rejects == 0``; rejections of
        never-fitting candidates are immune to blocked-entry changes), or
        the arrival's top-ranked pool was already registered strictly
        before the arrival's own position in the global order, making its
        visit a pure no-op. Checked arrivals are dropped: with no launch
        or terminal in between, capacity cannot have changed under them."""
        if self.placement is None:
            return not self._new_cands   # unconstrained: anything launches
        fb = self._futile_blocked
        if fb is None:
            return False                 # no futile certificate yet
        strict = self._futile_fit_rejects > 0
        if strict and (self.usage_halflife or self.policy == "fifo"):
            # decaying shares shift sort keys between passes (and fifo
            # never records fair keys): the positional check is unsound
            return False
        cands = self._new_cands
        live = self._queued_set
        while cands:
            jid = cands[-1]
            if jid in live:
                recs = self._dinfo.get(jid)
                if not recs:
                    return False
                for rec in recs:
                    used = rec[1]
                    fits = True
                    for n, amt, thr in rec[2]:
                        if used.get(n, 0.0) + amt > thr:
                            fits = False
                            break
                    if fits:
                        return False    # could launch: run the full scan
                if strict:
                    reg = fb.get(recs[0][0])
                    if reg is None:
                        return False    # would register a new blocked pool
                    key = self._job_of[jid].queue_key
                    conf = self._qconf[key]
                    gkey = (-(conf.priority + self._prio_of.get(jid, 0)),
                            self._usage[key] / conf.weight,
                            self._seq_of[jid])
                    if not reg < gkey:
                        return False    # would re-register it earlier
            cands.pop()
        return True

    def _queue_cands(self, w: _Window, depth: int) -> list:
        """The queue's first ``depth`` live entries in candidate sort
        order — a snapshot slice of the incrementally-maintained window
        when queue order equals sort order, a per-depth memoized sort
        otherwise. Always a copy: the window mutates under the pass as
        candidates launch, while a pass iterates its start-of-pass list
        (the pre-incremental semantics)."""
        rows = w.rows
        if w.fast:      # queue order == sort order
            return rows[:depth]
        per = w.per_depth
        if per is None:
            per = w.per_depth = {}
        d = depth if depth < len(rows) else -1   # -1 = full window
        got = per.get(d)
        if got is None:
            got = per[d] = sorted(rows if d < 0 else rows[:depth])
        return got

    def _candidate_heap(self, now: float) -> list:
        """One heap entry per non-empty, non-quota-full queue, keyed so a
        lazy pop-and-refill merge yields candidates in exactly the order
        the old full sort produced: ``(-priority, share, seq)`` under fair
        (share is constant per queue within a pass, so each queue's cached
        ``(-priority, seq)`` list is already globally sorted) and
        ``(seq,)`` under fifo. Entries carry (list, index) so only
        examined candidates are ever materialized; when a queue's
        remaining window is priority-uniform and strictly precedes every
        other stream, the whole window is consumed with no per-item heap
        traffic at all."""
        fifo = self.policy == "fifo"
        bdepth = self.backfill_depth if self.backfill else 0
        quota_k = self.quota_k
        heap = []
        for key, w in list(self._qwin.items()):
            live = self._qlen.get(key, 0)
            if live <= 0:
                continue
            headroom = quota_k - len(self._active[key])
            if headroom <= 0:
                continue
            if w.stale:
                self._win_refresh(key, w)
            depth = min(live, headroom + bdepth)
            if not w.rows:
                continue
            if fifo:
                lst = self._queue_cands(w, depth)
                if not lst:
                    continue
                heap.append((lst[0][0], key, lst, 0))
                continue
            share = self._decayed_usage(key, now) / \
                self._qconf[key].weight
            if w.fast:
                # lazy: the payload is the window itself — the slice is
                # only materialized if the pass actually scans it (until
                # a window is first iterated, its rows can only gain
                # appends at the end, so a later rows[:depth] slice is
                # identical to one taken now)
                r0 = w.rows[0]
                heap.append((r0[0], share, r0[1], key, w, depth, 0))
            else:
                lst = self._queue_cands(w, depth)
                if not lst:
                    continue
                heap.append((lst[0][0], share, lst[0][1], key, lst,
                             depth, 0))
        heapq.heapify(heap)
        return heap

    def _saturated(self) -> bool:
        """No queued job can possibly fit anywhere: on every pool some
        dimension's free capacity is below the smallest charge any of that
        pool's *live* queued jobs carries. The per-dim min-heaps are
        pruned lazily (launched/killed entries pop off the top), so the
        bound tightens as small jobs drain instead of going stale."""
        if not self._min_charge:
            return False
        live = self._queued_set
        for pname, cl in self.pools.items():
            heaps = self._min_charge.get(pname)
            if not heaps:
                continue        # no live job is eligible on this pool
            used = cl.used
            cap = cl.capacity
            blocked_dim = False
            any_live = False
            for n, h in heaps.items():
                while h and h[0][1] not in live:
                    heapq.heappop(h)
                if not h:
                    continue
                any_live = True
                if cap.get(n, 0.0) - used.get(n, 0.0) + 1e-9 < h[0][0]:
                    blocked_dim = True
                    break
            if any_live and not blocked_dim:
                return False    # this pool can still admit its smallest job
        return True

    def _packable(self, jid: str, rec) -> bool:
        """Node-level feasibility on top of the aggregate fit check:
        gangs ask the pool's packer for all pods; single jobs on a
        node-shaped pool ask it for one — aggregate free capacity can be
        fragmented across nodes, and launching on the aggregate alone
        would blow up in ``reserve_gang``. Pools without node accounting
        answer True for single jobs without a cluster call."""
        cl = self.pools[rec[0]]
        if rec[6] is not None:
            return cl.can_pack(rec[6][0], rec[6][1])
        if getattr(cl, "node_shape", None) is None:
            return True
        return cl.can_pack(self._opts_of[jid][rec[0]].resources, 1)

    def _visit(self, key: tuple, jid: str, blocked: dict,
               quota_used: dict, now: float, regkey) -> int:
        """Examine one candidate: 0 = rejected without fitting any pool
        (quota / capacity), 4 = fit some pool but was backfill-rejected,
        1 = launched, -1 = launched and the deployment saturated (stop
        the pass), -2 = convoy (head blocked under backfill-less strict
        ordering, stop the pass). ``regkey`` is the candidate's global
        sort key, recorded on the blocked entry it registers — the futile
        certificate the submit fast path checks new arrivals against.
        Mirrors the pre-incremental scan body decision-for-decision."""
        quota_k = self.quota_k
        used = quota_used.get(key, -1)
        if used < 0:
            used = len(self._active[key])
        if used >= quota_k:
            return 0
        chosen = None
        backfilled = False
        fit_any = False
        if self.placement is not None:
            recs = self._dinfo.get(jid)
            if recs is None:
                # pool set changed under a queued job: re-derive
                opts = self._ensure_opts(self._job_of[jid])
                if not opts:
                    job = self._job_of[jid]
                    self._remove_queued(key, jid)
                    self._fail_infeasible(job)
                    return 0
                recs = self._dinfo[jid]
            for rec in recs:
                used_d = rec[1]
                fits = True
                for n, amt, thr in rec[2]:
                    if used_d.get(n, 0.0) + amt > thr:
                        fits = False
                        break
                if not fits:
                    continue
                if not self._packable(jid, rec):
                    continue    # aggregate fits, pods don't node-pack
                fit_any = True
                pname = rec[0]
                blk = blocked.get(pname)
                if blk is not None:
                    shadow_eps = blk[3]
                    if shadow_eps is None:
                        continue    # no shadow estimate: stay conservative
                    dur = rec[5]
                    if dur is self._MISS:
                        dur = self._probe_duration(jid, pname)
                        rec[5] = dur
                    if dur is not None and now + dur <= shadow_eps:
                        backfilled = True   # ends before the blocked start
                    else:
                        spare = blk[2]
                        ok = True
                        citems = rec[3]
                        for n, amt in citems:
                            if amt > spare.get(n, 0.0) + 1e-9:
                                ok = False
                                break
                        if not ok:
                            continue
                        # this job may still be running at the shadow
                        # time: consume its share of the spare so later
                        # backfill candidates cannot collectively delay
                        # the blocked job
                        for n, amt in citems:
                            spare[n] = spare.get(n, 0.0) - amt
                        backfilled = True
                chosen = pname
                break
            if chosen is None:
                # fits no pool right now: reserve a shadow start on its
                # best-ranked pool (where placement wants it)
                top = recs[0][0]
                if top not in blocked:
                    shadow, spare = self._shadow_time(top, recs[0][4])
                    blocked[top] = [
                        recs[0][4], shadow, spare,
                        shadow + 1e-9 if shadow is not None else None,
                        regkey]
                if not self.backfill:
                    return -2
                return 4 if fit_any else 0
            if backfilled:
                self.stats["backfilled"] += 1
        self._launch(key, self._job_of[jid], chosen, now)
        quota_used[key] = used + 1
        return -1 if self._saturated() else 1

    def _dispatch_once(self) -> bool:
        if self._saturated():
            # nothing fits anywhere: a futile pass with no fit-rejected
            # candidates — a trivially valid certificate for the fast path
            self._futile_blocked = {}
            self._futile_fit_rejects = 0
            return False
        now = self._now()       # one clock read per pass: decay math and
        launched = False        # backfill estimates stay consistent
        # EASY shadow state is per pool: pool -> [blocked_req, shadow,
        # spare, shadow+eps, registrant sort key]; a blocked head
        # throttles only its own preferred pool
        blocked: dict[str, list] = {}
        quota_used: dict[tuple, int] = {}
        heap = self._candidate_heap(now)
        fifo = self.policy == "fifo"
        quota_k = self.quota_k
        live = self._queued_set
        visit = self._visit
        pop = heapq.heappop
        push = heapq.heappush
        fit_rejects = 0
        placement = self.placement
        bf_on = self.backfill
        active = self._active
        MISS = self._MISS
        while heap:
            ent = pop(heap)
            if fifo:
                seq, key, lst, i = ent
                end = len(lst)
                rows_src = lst
            else:
                negprio, share, _, key, payload, depth, i = ent
                if type(payload) is list:
                    lst = payload
                    end = len(lst)
                    rows_src = lst
                else:
                    # lazy fast window: rows gained at most appends since
                    # the heap was built, so rows[:depth] now equals the
                    # pass-start slice — defer the copy until (unless)
                    # the window is actually scanned
                    lst = None
                    end = depth
                    rows_src = payload.rows
            # bulk window: under fair ordering a queue's candidates are
            # consecutive whenever its (priority, share) strictly precedes
            # every other stream — consume the rest of the window with no
            # per-item heap traffic (the common case: shares rarely tie)
            if not fifo and rows_src[end - 1][0] == negprio and \
                    (not heap or (negprio, share) < (heap[0][0],
                                                     heap[0][1])):
                # window-level rejection certificate: for a pure
                # single-pool window, one aggregate check against the
                # blocked head's shadow/spare (or against free capacity)
                # can prove every candidate would be rejected — the
                # minimum charge / minimum duration proofs are monotone
                # in exactly the comparisons each visit would make
                w = self._qwin.get(key)
                if w is not None and bf_on and w.agg:
                    # evaluate the certificate per pool; verdicts:
                    #   1 — some pool could admit a member: scan normally
                    #   2 — every member provably rejected, but an
                    #       unregistered pool remains: the next live
                    #       candidate is visited (it registers its top
                    #       exactly as a full scan would), then the
                    #       certificate is re-evaluated — bounded, since
                    #       each round consumes a candidate
                    #   0 — every pool dead: the window rejects at once,
                    #       modulo duration-qualifiers
                    pools_d = self.pools
                    skip_mode = False
                    while True:
                        dur_alive = None
                        verdict = 0
                        for pname, (mins2, md2, unp2, _c) in \
                                w.agg.items():
                            used2 = pools_d[pname].used
                            fdead = False
                            for nm, (mn, thr) in mins2.items():
                                if used2.get(nm, 0.0) + mn > thr:
                                    fdead = True
                                    break
                            blk = blocked.get(pname)
                            if blk is None:
                                if fdead:
                                    verdict = 2     # rejected; may still
                                    continue        # register this pool
                                verdict = 1         # could admit here
                                break
                            if fdead:
                                continue    # blocked + unfittable: dead
                            se2 = blk[3]
                            if se2 is None:
                                continue    # pool conservatively dead
                            spare2 = blk[2]
                            sdead = False
                            for nm, (mn, _t) in mins2.items():
                                if mn > spare2.get(nm, 0.0) + 1e-9:
                                    sdead = True
                                    break
                            if not sdead:
                                verdict = 1         # spare-path alive
                                break
                            if unp2:
                                verdict = 1         # unknown durations
                                break
                            if md2 is not None and now + md2 <= se2:
                                if dur_alive is None:
                                    dur_alive = []
                                dur_alive.append((pname, se2))
                        if verdict == 1:
                            break           # genuine full scan
                        if verdict == 2:
                            if lst is None:
                                # a visit can launch (and thus mutate
                                # the live window): snapshot first
                                lst = rows_src[:end]
                                rows_src = lst
                            r = None
                            while i < end:
                                row = rows_src[i]
                                jid = row[2]
                                i += 1
                                if jid in live:
                                    r = visit(key, jid, blocked,
                                              quota_used, now,
                                              (row[0], share, row[1]))
                                    break
                            if r == 1 or r == -1:
                                # a duration-qualifier on a still-alive
                                # pool launched (the certificate only
                                # proves non-qualifiers rejected)
                                launched = True
                                if r == -1:
                                    return True     # saturated: stop
                            if r is not None and i < end:
                                continue    # re-evaluate post-register
                            skip_mode = True    # window exhausted
                            dur_alive = None
                            break
                        skip_mode = True
                        break
                    if skip_mode:
                        # may hide fit-but-rejected candidates: keep the
                        # futile certificate conservative
                        fit_rejects += 1
                        if dur_alive is None:
                            continue        # whole window rejects
                        if w.fast:
                            lo = rows_src[i][1]
                            hi = rows_src[end - 1][1]
                            quals = {}
                            for pname, se2 in dur_alive:
                                for dq in w.pdurs.get(pname, ()):
                                    if now + dq[0] > se2:
                                        break       # sorted: rest fail
                                    s2 = dq[2]
                                    if lo <= s2 <= hi and dq[3] in live:
                                        quals[dq[3]] = (dq[1], s2,
                                                        dq[3], dq[4])
                            lst = sorted(quals.values())
                            i = 0
                            end = len(lst)
                if lst is None:
                    lst = rows_src[:end]    # == the pass-start slice
                stop = False
                while i < end:
                    row = lst[i]
                    jid = row[2]
                    i += 1
                    if jid not in live:
                        continue
                    recs = row[3]
                    if recs is None and placement is not None:
                        # pool set changed under the job: slow path
                        r = visit(key, jid, blocked, quota_used, now,
                                  (row[0], share, row[1]))
                        if r == 1:
                            launched = True
                            continue
                        if r == 4:
                            fit_rejects += 1
                            continue
                        if r == -1:
                            launched = True
                            stop = True
                            break
                        if r == -2:
                            stop = True
                            break
                        if quota_used.get(key, 0) >= quota_k:
                            break
                        continue
                    # inlined _visit hot path (same decisions, no call /
                    # dinfo lookup per candidate — recs ride on the row)
                    used = quota_used.get(key, -1)
                    if used < 0:
                        used = len(active[key])
                    if used >= quota_k:
                        if key in quota_used:
                            break   # quota pinned: rest of window skipped
                        continue
                    chosen = None
                    backfilled = False
                    fit_any = False
                    if placement is not None:
                        for rec in recs:
                            used_d = rec[1]
                            fits = True
                            for n, amt, thr in rec[2]:
                                if used_d.get(n, 0.0) + amt > thr:
                                    fits = False
                                    break
                            if not fits:
                                continue
                            if not self._packable(jid, rec):
                                continue    # pods don't node-pack
                            fit_any = True
                            pname = rec[0]
                            blk = blocked.get(pname)
                            if blk is not None:
                                shadow_eps = blk[3]
                                if shadow_eps is None:
                                    continue
                                dur = rec[5]
                                if dur is MISS:
                                    dur = self._probe_duration(jid, pname)
                                    rec[5] = dur
                                if dur is not None and \
                                        now + dur <= shadow_eps:
                                    backfilled = True
                                else:
                                    spare = blk[2]
                                    ok = True
                                    for n, amt in rec[3]:
                                        if amt > spare.get(n, 0.0) + 1e-9:
                                            ok = False
                                            break
                                    if not ok:
                                        continue
                                    for n, amt in rec[3]:
                                        spare[n] = spare.get(n, 0.0) - amt
                                    backfilled = True
                            chosen = pname
                            break
                        if chosen is None:
                            top = recs[0][0]
                            if top not in blocked:
                                shadow, spare0 = self._shadow_time(
                                    top, recs[0][4])
                                blocked[top] = [
                                    recs[0][4], shadow, spare0,
                                    shadow + 1e-9 if shadow is not None
                                    else None,
                                    (row[0], share, row[1])]
                            if not bf_on:
                                stop = True     # convoy
                                break
                            if fit_any:
                                fit_rejects += 1
                            if key in quota_used and \
                                    quota_used[key] >= quota_k:
                                break
                            continue
                        if backfilled:
                            self.stats["backfilled"] += 1
                    self._launch(key, self._job_of[jid], chosen, now)
                    quota_used[key] = used + 1
                    launched = True
                    if self._saturated():
                        stop = True
                        break
                if stop:
                    break
                continue
            # item-level merge (fifo, priority-mixed windows, share ties)
            if lst is None:
                lst = rows_src[:end]        # == the pass-start slice
            row = lst[i]
            jid = row[2] if not fifo else row[1]
            i += 1
            if i < end and quota_used.get(key, -1) < quota_k:
                nxt = lst[i]
                if fifo:
                    push(heap, (nxt[0], key, lst, i))
                else:
                    push(heap, (nxt[0], share, nxt[1], key, lst, end, i))
            if jid not in live:
                continue        # launched/killed by a nested event
            r = visit(key, jid, blocked, quota_used, now,
                      None if fifo else (row[0], share, row[1]))
            if r == 1:
                launched = True
                continue
            if r == 4:
                fit_rejects += 1
                continue
            if r == -1:
                launched = True
                break
            if r == -2:
                break           # convoy: strict order blocks the rest
        if not launched:
            # record the futile certificate: which pools got blocked
            # entries and where in the global order they were registered
            self._futile_blocked = {p: blk[4] for p, blk in blocked.items()}
            self._futile_fit_rejects = fit_rejects
        return launched

    def _launch(self, key: tuple, job: Job, pool: Optional[str] = None,
                now: Optional[float] = None) -> None:
        jid = job.job_id
        self._remove_queued(key, jid)
        self._active[key].add(jid)
        reserved = None
        try:
            if pool is not None:
                opt = self._opts_of[jid][pool]
                cl = self.pools[pool]
                if opt.pods > 1 or \
                        getattr(cl, "node_shape", None) is not None:
                    # gangs reserve atomically (all pods or none); on a
                    # node-shaped pool even single jobs go through the
                    # node packer so the per-node books stay consistent
                    reserved = cl.reserve_gang(jid, opt.resources,
                                               opt.pods)
                    job.gang_pods = opt.pods if opt.pods > 1 else None
                else:
                    reserved = cl.reserve(jid, opt.resources)
                job.pool = pool
                # pin the concrete shape the job got (a per-pool menu
                # entry), so runner billing and observers see what was
                # allocated
                job.spec.resources = dict(opt.resources)
                self.stats["placed_by_pool"][pool] += 1
            if now is None:
                now = self._now()
            self._started_at[jid] = now
            t_s = getattr(job.spec, "timeout_s", None)
            if t_s is not None:
                # per-incarnation runtime limit: stamped with this epoch
                # so a retry/preempt relaunch gets its own fresh timer
                # and the old one expires as a no-op
                heapq.heappush(self._timers,
                               (now + t_s, 0, jid, job.epoch))
            wait = now - self._queued_at.pop(jid, now)
            self.stats["launched"] += 1
            self.stats["wait_count"] += 1
            self.stats["wait_sum"] += wait
            by_key = self.stats["wait_by_key"][key]
            by_key[0] += 1
            by_key[1] += wait
            self.registry.set_state(jid, JobState.LAUNCHING)
            self.launcher.launch(job)
            # feed the pool's incremental shadow state with the runner's
            # expected completion — available only after launch. A runner
            # that completed the job synchronously already settled it
            # (the nested event popped _started_at), so there is nothing
            # to track.
            if pool is not None and jid in self._started_at:
                end = self.launcher.expected_end(jid) \
                    if self._has_end else None
                if end is None:
                    self._unknown_ends[pool] = \
                        self._unknown_ends.get(pool, 0) + 1
                    self._end_key[jid] = (pool, None)
                else:
                    self._lseq += 1
                    insort(self._pool_ends.setdefault(pool, []),
                           (end, self._lseq, jid, reserved))
                    self._end_key[jid] = (pool, (end, self._lseq))
        except Exception as exc:
            self._abort_launch(key, jid, job, pool, exc)
            raise

    def _abort_launch(self, key: tuple, job_id: str, job: Job,
                      pool: Optional[str], exc: BaseException) -> None:
        """Unwind a launch that raised partway: hand back the
        reservation (idempotent — a no-op when reserve itself was what
        raised), drop the half-made bookkeeping, and terminal-ize the
        job as FAILED so it cannot strand in LAUNCHING while holding
        nothing. The caller re-raises; this only restores the books."""
        if pool is not None:
            cl = self.pools.get(pool)
            if cl is not None:
                cl.release(job_id)
        job.pool = None
        job.gang_pods = None
        self._active[key].discard(job_id)
        self._started_at.pop(job_id, None)
        self._drop_shadow(job_id)
        failed = None
        if job.state not in TERMINAL_STATES:
            try:
                if job.state != JobState.LAUNCHING:
                    self.registry.set_state(job_id, JobState.LAUNCHING)
                failed = self.registry.set_state(
                    job_id, JobState.FAILED,
                    error=f"launch aborted: {exc}",
                    expect_epoch=job.epoch)
            except IllegalTransition:
                pass    # a racing transition won; leave its state alone
        self._state_rev += 1
        self._dirty_full = True
        if failed is not None:
            self.registry.persist_state(job_id)
            self.bus.publish(TOPIC_CONTAINER_STATUS,
                             {"job_id": job_id, "status": "FAILED",
                              "epoch": job.epoch})

    def _fail_infeasible(self, job: Job,
                         err: Optional[str] = None) -> None:
        if err is None:
            err = (f"resources "
                   f"{job.spec.pool_resources or job.spec.resources} "
                   f"exceed cluster capacity on every pool "
                   f"({self.placement.explain_infeasible(job.spec)})")
        self.registry.set_state(job.job_id, JobState.LAUNCHING)
        self.registry.set_state(job.job_id, JobState.FAILED, error=err,
                                expect_epoch=job.epoch)
        # never reached a runner, so no worker log exists: make the
        # reason the log, so `acai logs <job>` answers "why did it fail"
        job.outputs.setdefault("log", err)
        self.registry.persist_state(job.job_id)
        self._state_rev += 1
        self.bus.publish(TOPIC_CONTAINER_STATUS,
                         {"job_id": job.job_id, "status": "FAILED",
                          "epoch": job.epoch})

    # -- EASY backfill ---------------------------------------------------
    def _shadow_time(self, pool: str,
                     blocked_req: dict) -> tuple[Optional[float],
                                                 Optional[dict]]:
        """Earliest time the blocked job fits on ``pool`` (shadow start)
        and the capacity left spare there at that instant after it starts.
        Walks the pool's incrementally-maintained sorted expected-end list
        instead of re-copying and re-sorting every reservation; if any
        running job's end is unknown (the launcher could not estimate it)
        backfill stays conservative (disabled for this round)."""
        cl = self.pools.get(pool)
        if cl is None or self._unknown_ends.get(pool, 0):
            return None, None
        used = cl.used
        free = {n: cap - used[n] for n, cap in cl.capacity.items()}
        for end, _, _, res in self._pool_ends.get(pool, ()):
            for n, amt in res.items():
                if n in free:
                    free[n] += amt
            fits = True
            for n in blocked_req:
                if free.get(n, 0.0) < blocked_req[n] - 1e-9:
                    fits = False
                    break
            if fits:
                spare = {n: free.get(n, 0.0) - blocked_req[n]
                         for n in blocked_req}
                return end, spare
        return None, None

    def _probe_duration(self, jid: str, pool: str) -> Optional[float]:
        """Launcher runtime estimate for the backfill test, memoized into
        the job's dispatch record by the caller (the value is drawn once
        per (job, pool), so the hot path skips the launcher's
        getattr/try-except plumbing on every probe). The estimate is for
        THIS pool: a job that is quick on CPU but pays a TPU startup tax
        must be sized at its TPU runtime when backfilling the TPU pool's
        hole."""
        if not self._has_dur:
            return None
        job = self._job_of[jid]
        if self._dur_takes_pool is None:
            # classify the launcher's signature once, by inspection — a
            # TypeError raised *inside* a pool-aware estimator must not
            # silently demote every future probe to pool-less sizing
            try:
                params = inspect.signature(
                    self.launcher.expected_duration).parameters
                self._dur_takes_pool = "pool" in params or any(
                    p.kind is inspect.Parameter.VAR_KEYWORD
                    for p in params.values())
            except (TypeError, ValueError):
                self._dur_takes_pool = True     # builtins: assume modern
        if self._dur_takes_pool:
            return self.launcher.expected_duration(job, pool=pool)
        return self.launcher.expected_duration(job)

    # -- terminal events -------------------------------------------------
    def _on_container_status(self, msg: dict) -> None:
        status = msg.get("status", "")
        if status not in TERMINAL_STATUS_VALUES:
            return
        with self._lock:
            job_id = msg["job_id"]
            try:
                job = self.registry.get(job_id)
            except KeyError:
                # cross-process event sources (a surviving worker's
                # replayed buffer, a persisted event stream) can name
                # jobs this engine never registered — ignore, don't die
                return
            epoch = msg.get("epoch")
            if epoch is not None and epoch < job.epoch:
                # stale event from a pre-preemption incarnation (e.g. a
                # thread worker that finished after its job was preempted
                # and relaunched): settling it would release — and
                # fair-share-charge — the *new* incarnation's reservation
                return
            key = job.queue_key
            self._active[key].discard(job_id)
            if status == JobState.FAILED.value:
                retried = self._maybe_retry(job, key, msg)
                # decision made either way: lower the retry latch so
                # waiters may trust the registry's FAILED again
                job.retry_pending = False
                if retried:
                    # requeued as a new epoch: not terminal — no
                    # dependent cascade, no terminal settle (the failed
                    # segment was already settled preemption-style
                    # inside _maybe_retry)
                    self._dispatch()
                    return
            if status == JobState.FINISHED.value and \
                    key in self._user_fails:
                self._user_fails.pop(key)   # a success resets the
                                            # queue's failure budget
            self._release_dependents(job_id, status)
            self._settle(job_id, key)
            self._dispatch()

    def _settle(self, job_id: str, key: tuple) -> None:
        """Release capacity on the job's pool, free per-job bookkeeping,
        and charge fair-share usage. Idempotent (a killed virtual job
        later pops off the clock and publishes KILLED again), and
        usage/completed only accrue for jobs that actually launched."""
        job = self.registry.get(job_id)
        pool_cl, released, started_at = self._release_segment(job_id, job)
        self._prio_of.pop(job_id, None)
        self._opts_of.pop(job_id, None)
        self._rank_of.pop(job_id, None)
        self._dinfo.pop(job_id, None)
        self._job_of.pop(job_id, None)
        self._seq_of.pop(job_id, None)
        self._queued_at.pop(job_id, None)
        if self._can_forget:
            # the job is terminal: the launcher may hold restore state
            # (checkpoint progress) for it that no live run will reclaim
            self.launcher.forget(job_id)
        self._settles += 1
        if self._settles % 256 == 0:
            self._compact_min_charge()
        self._state_rev += 1
        if started_at is None:
            return          # never launched (queued kill / infeasible)
        runtime = job.runtime
        if runtime is None:
            runtime = max(0.0, self._now() - started_at)
        # fair-share usage is the dominant share on the pool the job ran
        # on: consuming half the TPU pool weighs like half the CPU pool
        self._charge_segment(key, job, pool_cl, released, runtime)
        self.stats["completed"] += 1

    def _drop_shadow(self, job_id: str) -> None:
        """Drop the job from its pool's incremental EASY shadow state
        (O(log n) locate) — shared by terminal settle and preemption."""
        ek = self._end_key.pop(job_id, None)
        if ek is not None:
            pool_name, sort_key = ek
            if sort_key is None:
                self._unknown_ends[pool_name] = \
                    max(0, self._unknown_ends.get(pool_name, 0) - 1)
            else:
                ends = self._pool_ends.get(pool_name)
                if ends:
                    i = bisect_left(ends, sort_key)
                    if i < len(ends) and ends[i][2] == job_id:
                        ends.pop(i)

    def _compact_min_charge(self) -> None:
        """Periodic sweep of the saturation heaps: lazy pruning only
        removes dead entries when they surface at the top, so a long-lived
        engine occasionally rebuilds heaps that are mostly tombstones."""
        live = self._queued_set
        bound = max(64, 4 * len(live))
        for heaps in self._min_charge.values():
            for n, h in heaps.items():
                if len(h) > bound:
                    kept = [e for e in h if e[1] in live]
                    heapq.heapify(kept)
                    heaps[n] = kept

    # -- fair-share usage with half-life decay ---------------------------
    def _decayed_usage(self, key: tuple,
                       now: Optional[float] = None) -> float:
        """Accumulated usage decayed since its last update; without a
        half-life this is plain accumulation (the pre-decay behaviour)."""
        usage = self._usage[key]
        if self.usage_halflife and usage:
            now = self._now() if now is None else now
            dt = now - self._usage_t.get(key, now)
            if dt > 0:
                usage *= 0.5 ** (dt / self.usage_halflife)
        return usage

    def _charge_usage(self, key: tuple, amount: float) -> None:
        now = self._now()
        self._usage[key] = self._decayed_usage(key, now) + amount
        self._usage_t[key] = now

    def _publish_snapshot(self) -> None:
        """Coalesced scheduler snapshot: skipped when nothing changed
        since the last publish, and rate-limited to one per
        ``snapshot_interval`` runner-clock seconds when configured."""
        if not self.pools:
            return
        if self._state_rev == self._pub_rev:
            return
        now = self._now()
        if self.snapshot_interval and \
                now - self._pub_t < self.snapshot_interval:
            self.stats["snapshots_skipped"] += 1
            return
        self._pub_rev = self._state_rev
        self._pub_t = now
        self.stats["snapshots"] += 1
        self.bus.publish(TOPIC_SCHEDULER, {
            "now": now,
            "utilization": self.utilization(),
            "pools": sorted(self.pools),
            "queued": sum(self._qlen.values()),
            "held": len(self._held),
            "active": sum(len(a) for a in self._active.values()),
            "preempted": self.stats["preempted"],
        })

    # ------------------------------------------------------------------
    def queue_depth(self, project: str, user: str) -> int:
        with self._lock:
            return self._qlen.get((project, user), 0)

    def active_count(self, project: str, user: str) -> int:
        with self._lock:
            return len(self._active[(project, user)])

    def held_count(self) -> int:
        """Jobs held out of dispatch on unmet declared dependencies."""
        with self._lock:
            return len(self._held)

    def utilization(self) -> dict[str, float]:
        """Per-dimension utilization; in a multi-pool deployment keys are
        namespaced ``"<pool>/<dim>"`` (the single default pool keeps the
        flat legacy keys)."""
        pools = self.pools
        if not pools:
            return {}
        if len(pools) == 1 and "default" in pools:
            return pools["default"].utilization()
        return {f"{pname}/{dim}": u
                for pname in sorted(pools)
                for dim, u in pools[pname].utilization().items()}

    def pool_utilization(self) -> dict[str, dict[str, float]]:
        """{pool: {dim: utilization}} across the deployment."""
        return {pname: cl.utilization() for pname, cl in self.pools.items()}

    def mean_queue_wait(self) -> float:
        n = self.stats["wait_count"]
        return self.stats["wait_sum"] / n if n else 0.0

    # -- quorum / straggler mitigation ----------------------------------
    def run_until_quorum(self, job_ids: list[str], frac: float = 0.95,
                         kill_stragglers: bool = True) -> dict:
        """Advance the virtual runner until ``frac`` of jobs are terminal
        (the paper waits for 95 % of profiling jobs to cope with
        stragglers). Remaining stragglers are optionally killed.
        Only meaningful with a VirtualRunner launcher."""
        need = int(frac * len(job_ids) + 0.999999)
        done = lambda: [j for j in job_ids
                        if self.registry.get(j).state in TERMINAL_STATES]
        while len(done()) < need and self.launcher.pending() > 0:
            self.launcher.step()
        finished = done()
        stragglers = [j for j in job_ids
                      if self.registry.get(j).state not in TERMINAL_STATES]
        if kill_stragglers:
            for j in stragglers:
                self.kill(j)
        return {"finished": finished, "stragglers": stragglers,
                "virtual_time": getattr(self.launcher, "now", None)}

    def run_to_completion(self) -> None:
        """Drain the runner completely (virtual clock or thread pool)."""
        while self.launcher.pending() > 0:
            self.launcher.step()
