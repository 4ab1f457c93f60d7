"""ACAI facade: credential server + project workspaces + SDK surface.

A copy of ``repro/core/acai.py``, with its imports in ``repro_torch.core``.
The durable control plane (``durable=``) and the subprocess runner are not
copied yet (ROADMAP A5): asking for either raises ``NotImplementedError``
instead of building an engine without it.

Mirrors the paper's public surface (§3.1, §3.4, §4.1): a global admin
creates projects; each project has an admin user who creates member users;
every request carries a user token which the credential server resolves to
(user, project) before dispatch. Per-project state (storage, filesets,
metadata, provenance) is isolated; the execution engine is shared.
"""
from __future__ import annotations

import dataclasses
import secrets
import warnings
from pathlib import Path
from typing import Callable, Optional

from repro_torch.core.datalake.fileset import FileSetManager
from repro_torch.core.datalake.metadata import MetadataStore
from repro_torch.core.datalake.provenance import ProvenanceGraph
from repro_torch.core.datalake.storage import Storage
from repro_torch.core.engine.cluster import Cluster
from repro_torch.core.engine.events import EventBus
from repro_torch.core.engine.placement import Placement
from repro_torch.core.engine.handle import JobHandle, wait_all
from repro_torch.core.engine.launcher import (LocalRunner, ThreadPoolRunner,
                                              VirtualRunner)
from repro_torch.core.engine.monitor import JobMonitor
from repro_torch.core.engine.pipeline import Pipeline
from repro_torch.core.engine.registry import JobRegistry, JobSpec
from repro_torch.core.engine.scheduler import Scheduler
from repro_torch.core.provision.autoprovision import AutoProvisioner
from repro_torch.core.provision.pricing import CPU_PRICING, Pricing
from repro_torch.core.provision.profiler import Profiler


class AuthError(RuntimeError):
    pass


@dataclasses.dataclass
class User:
    name: str
    project: str
    token: str
    is_admin: bool = False


class AcaiProject:
    """Isolated workspace: data lake + metadata + provenance."""

    def __init__(self, name: str, root):
        self.name = name
        root = Path(root)
        root.mkdir(parents=True, exist_ok=True)
        self.storage = Storage(root)
        self.metadata = MetadataStore(root)
        self.provenance = ProvenanceGraph(root)
        self.filesets = FileSetManager(self.storage, self.provenance)

    # SDK conveniences -------------------------------------------------
    def upload(self, path: str, data: bytes, creator: str = "") -> str:
        fv = self.storage.upload(path, data, creator)
        self.metadata.register(f"{path}@{fv.version}", kind="file",
                               creator=creator)
        return f"{path}@{fv.version}"

    def create_file_set(self, name: str, specs: list[str],
                        creator: str = "") -> str:
        fsv = self.filesets.create(name, specs, creator)
        self.metadata.register(fsv.ref, kind="fileset", creator=creator)
        return fsv.ref


class AcaiEngine:
    """Execution engine assembly: registry + scheduler + launcher + monitor.

    ``pricing`` is either one ``Pricing`` (homogeneous deployment, at most
    one capacity cluster) or a catalog ``{family: Pricing}`` — then
    ``cluster_nodes`` (an int for every family, or ``{family: nodes}``)
    builds one ``Cluster`` pool per family and a ``Placement`` layer
    chooses a pool per job (profiler-fed via :meth:`use_profiler`).
    """

    def __init__(self, *, datalake: Optional[AcaiProject] = None,
                 pricing: Pricing | dict[str, Pricing] = CPU_PRICING,
                 quota_k: int = 2,
                 virtual: bool = False,
                 oracle: Optional[Callable] = None,
                 workroot: Optional[str] = None,
                 runner: Optional[str] = None, max_workers: int = 4,
                 cluster: Optional[Cluster] = None,
                 cluster_nodes: Optional[int | dict[str, int]] = None,
                 placement: Optional[Placement] = None,
                 placement_objective: str = "cost",
                 policy: str = "fair", backfill: bool = True,
                 usage_halflife: Optional[float] = None,
                 preemption: bool = False,
                 starvation_threshold: float = 300.0,
                 quarantine_threshold: int = 3,
                 user_failure_budget: Optional[int] = None,
                 checkpoint_interval: Optional[float] = None,
                 durable: Optional[str | Path] = None):
        # the durable control plane (``durable=<dir>``: the write-ahead
        # journal, snapshot store and recovery of the paper's Redis-backed
        # engine state) is not ported yet; ``store``, ``journal`` and
        # ``recovery`` stay None, as in a reference engine without it; its
        # ``snapshot_every`` and ``recover`` options come with it (ROADMAP A5).
        # ``workroot`` defaults to <TMPDIR>/acai-jobs, not the reference's
        # fixed /tmp/acai-jobs
        if durable is not None:
            raise NotImplementedError(
                "durable=: the durable control plane (journal, snapshot "
                "store, recovery) is not ported yet (ROADMAP A5)")
        self.store = self.journal = self.recovery = None
        self.bus = EventBus()
        self.datalake = datalake
        self.registry = JobRegistry(
            metadata=datalake.metadata if datalake else None)
        runner = runner or ("virtual" if virtual else "local")
        if runner == "virtual":
            self.launcher = VirtualRunner(
                self.registry, self.bus, oracle=oracle, pricing=pricing,
                checkpoint_interval=checkpoint_interval)
        elif runner == "thread":
            self.launcher = ThreadPoolRunner(self.registry, self.bus,
                                             datalake=datalake,
                                             pricing=pricing,
                                             workroot=workroot,
                                             max_workers=max_workers)
        elif runner == "local":
            self.launcher = LocalRunner(self.registry, self.bus,
                                        datalake=datalake, pricing=pricing,
                                        workroot=workroot)
        elif runner == "subprocess":
            raise NotImplementedError(
                "runner='subprocess': the subprocess runner is part of the "
                "durable control plane, which is not ported yet (ROADMAP A5)")
        else:
            raise ValueError(f"unknown runner {runner!r}")
        catalog = pricing if isinstance(pricing, dict) else None
        if catalog and placement is None and cluster_nodes is None:
            # without pools there is no placement and billing would fall
            # back to an arbitrary catalog entry — refuse loudly
            raise ValueError(
                "a pricing catalog needs cluster_nodes (int or "
                "{family: nodes}) or an explicit placement= to build "
                "its pools; pass a single Pricing for a pool-less engine")
        if placement is None and catalog and cluster_nodes is not None:
            nodes = cluster_nodes if isinstance(cluster_nodes, dict) \
                else {fam: cluster_nodes for fam in catalog}
            pools = {fam: Cluster.from_pricing(p, nodes=nodes[fam],
                                               name=fam)
                     for fam, p in catalog.items() if nodes.get(fam)}
            placement = Placement(pools, pricing=catalog,
                                  objective=placement_objective)
        if cluster is None and placement is None \
                and cluster_nodes is not None and not catalog:
            cluster = Cluster.from_pricing(pricing, nodes=cluster_nodes)
        self.scheduler = Scheduler(self.registry, self.launcher, self.bus,
                                   quota_k=quota_k, cluster=cluster,
                                   placement=placement,
                                   policy=policy, backfill=backfill,
                                   usage_halflife=usage_halflife,
                                   preemption=preemption,
                                   starvation_threshold=starvation_threshold,
                                   quarantine_threshold=quarantine_threshold,
                                   user_failure_budget=user_failure_budget)
        self.cluster = cluster
        self.monitor = JobMonitor(self.bus, registry=self.registry)
        self.pricing = pricing

    @property
    def pools(self) -> dict[str, Cluster]:
        return self.scheduler.pools

    def use_profiler(self, profiler, *, feedback: bool = False) -> None:
        """Feed a profiler's runtime predictions into pool placement
        (no-op without a placement layer). ``feedback=True`` also closes
        the loop: every FINISHED job's measured runtime is folded back
        into the profiler's per-pool model (``"<tmpl>@<pool>"``) via
        ``add_observation``, so cold-start priors and mispredictions
        self-correct online. Off by default — scheduling decisions are
        bit-identical to a feedback-less engine until opted in."""
        if self.scheduler.placement is not None:
            self.scheduler.placement.use_profiler(profiler)
        if feedback:
            profiler.attach_feedback(self.bus, self.registry)

    def submit(self, spec: JobSpec, *, pipeline: str = "") -> JobHandle:
        """Submit a job; returns a JobHandle future. Declared dependencies
        (``spec.depends_on``) are recorded as provenance edges before the
        job runs and gate its launch in the scheduler."""
        parents = []
        for pid in dict.fromkeys(spec.depends_on or ()):
            try:
                parents.append(self.registry.get(pid))
            except KeyError:
                # validated before the job is created: a bad dependency
                # must not leave a zombie QUEUED job behind
                raise ValueError(f"job {spec.name!r} depends on unknown "
                                 f"job {pid!r}") from None
        if self.scheduler.placement is not None:
            # like bad dependencies, a pool name that doesn't exist is a
            # caller typo — reject before the job is created rather than
            # burning a job id on a guaranteed-infeasible submit
            known = self.scheduler.placement.pools
            bad = [p for p in {spec.pool, *(spec.pool_resources or ())}
                   if p is not None and p not in known]
            if bad:
                raise ValueError(
                    f"job {spec.name!r} names unknown pool(s) "
                    f"{sorted(bad)!r}; available: {sorted(known)!r}")
        job = self.registry.submit(spec)
        if self.datalake is not None:
            for parent in parents:
                self.datalake.provenance.add_dependency_edge(
                    src_job=parent.job_id, dst_job=job.job_id,
                    pipeline=pipeline,
                    src_fileset=parent.spec.output_fileset,
                    dst_fileset=spec.input_fileset)
        self.scheduler.submit(job)
        return JobHandle(job, self)

    def pipeline(self, name: str = "pipeline") -> Pipeline:
        """A DAG builder whose stages submit to this engine."""
        return Pipeline(self, name=name)

    def wait_all(self, handles: Optional[list[JobHandle]] = None,
                 timeout: Optional[float] = None):
        """Resolve the given handles (or drain every pending job)."""
        if handles is not None:
            return wait_all(handles, timeout)
        if hasattr(self.launcher, "pending"):
            self.scheduler.run_to_completion()
        return None

    def run_all(self) -> None:
        """Deprecated: drain the engine. Prefer keeping the JobHandles
        from submit() and calling ``wait_all(handles)`` / ``h.result()``."""
        warnings.warn("AcaiEngine.run_all() is deprecated; use the "
                      "JobHandle futures returned by submit() "
                      "(wait_all(handles), handle.result())",
                      DeprecationWarning, stacklevel=2)
        self.wait_all()


class _UserEngine:
    """Engine view bound to a user token: specs submitted through it are
    stamped with the token's (project, user) exactly like ``submit_job``.
    Everything else (registry, scheduler, monitor, ...) proxies to the
    project's engine — the profiler's fleets run as the requesting user
    without hand-rolled submit shims."""

    def __init__(self, platform: "AcaiPlatform", token: str):
        self._platform = platform
        self._token = token
        self._engine = platform.engine(token)

    def submit(self, spec: JobSpec, **kw) -> JobHandle:
        return self._platform.submit_job(self._token, spec, **kw)

    def __getattr__(self, name):
        return getattr(self._engine, name)


class AcaiPlatform:
    """Credential server + project/user management (§3.1, §4.1)."""

    def __init__(self, root: str | Path, *,
                 pricing: Pricing | dict[str, Pricing] = CPU_PRICING,
                 virtual: bool = False, oracle=None, quota_k: int = 2,
                 runner: Optional[str] = None, max_workers: int = 4,
                 cluster_nodes: Optional[int | dict[str, int]] = None,
                 policy: str = "fair", backfill: bool = True,
                 usage_halflife: Optional[float] = None,
                 durable: bool = False):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._users: dict[str, User] = {}      # token -> user
        self._projects: dict[str, AcaiProject] = {}
        self._engines: dict[str, AcaiEngine] = {}
        self._admin_token = secrets.token_hex(8)
        self._pricing = pricing
        self._virtual = virtual
        self._oracle = oracle
        self._quota_k = quota_k
        self._runner = runner
        self._max_workers = max_workers
        self._cluster_nodes = cluster_nodes
        self._policy = policy
        self._backfill = backfill
        self._usage_halflife = usage_halflife
        # durable=True journals each project engine's state under
        # <root>/<project>/state in the reference; refused here, before
        # any project exists, rather than building non-durable engines
        if durable:
            raise NotImplementedError(
                "durable=True: the durable control plane is not ported "
                "yet (ROADMAP A5)")

    # -- credential server ----------------------------------------------
    @property
    def admin_token(self) -> str:
        return self._admin_token

    def authenticate(self, token: str) -> User:
        user = self._users.get(token)
        if user is None:
            raise AuthError("invalid token")
        return user

    def create_project(self, admin_token: str, name: str) -> str:
        """Global admin creates a project + its admin user; returns the
        project-admin token."""
        if admin_token != self._admin_token:
            raise AuthError("only the global administrator creates projects")
        if name in self._projects:
            raise ValueError(f"project {name} exists")
        self._projects[name] = AcaiProject(name, self.root / name)
        self._engines[name] = AcaiEngine(
            datalake=self._projects[name], pricing=self._pricing,
            virtual=self._virtual, oracle=self._oracle,
            quota_k=self._quota_k, runner=self._runner,
            max_workers=self._max_workers,
            cluster_nodes=self._cluster_nodes,
            policy=self._policy, backfill=self._backfill,
            usage_halflife=self._usage_halflife,
            workroot=str(self.root / name / "jobs"))
        return self.create_user(None, name, f"{name}-admin", _admin=True)

    def create_user(self, admin_token: Optional[str], project: str,
                    username: str, _admin: bool = False) -> str:
        if not _admin:
            admin = self.authenticate(admin_token)
            if not (admin.is_admin and admin.project == project):
                raise AuthError("only the project administrator creates users")
        token = secrets.token_hex(8)
        self._users[token] = User(username, project, token, is_admin=_admin)
        return token

    # -- authenticated SDK dispatch ---------------------------------------
    def project(self, token: str) -> AcaiProject:
        return self._projects[self.authenticate(token).project]

    def engine(self, token: str) -> AcaiEngine:
        return self._engines[self.authenticate(token).project]

    def submit_job(self, token: str, spec: JobSpec, *,
                   pipeline: str = "") -> JobHandle:
        user = self.authenticate(token)
        spec.project = user.project
        spec.user = user.name
        return self._engines[user.project].submit(spec, pipeline=pipeline)

    def pipeline(self, token: str, name: str = "pipeline") -> Pipeline:
        """A DAG builder bound to the caller: stage specs are stamped with
        the token's (project, user) at submit, like ``submit_job``."""
        eng = self.engine(token)
        return Pipeline(eng, name=name,
                        submit=lambda spec: self.submit_job(
                            token, spec, pipeline=name))

    def make_profiler(self, token: str, quorum: float = 0.95,
                      priority: int = 0) -> Profiler:
        prof = Profiler(_UserEngine(self, token), quorum=quorum,
                        priority=priority)
        # profiler-fed placement: predictions flow into the project's pool
        # scoring as soon as models are fit (no-op on single-pool engines)
        self.engine(token).use_profiler(prof)
        return prof

    def make_autoprovisioner(self, token: str,
                             profiler: Profiler) -> AutoProvisioner:
        return AutoProvisioner(profiler, self._pricing)
