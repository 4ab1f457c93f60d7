"""The port's execution engine (``repro_torch.core``) against the
reference's (``repro.core``) on the virtual clock: the same scenario through
each package's ``AcaiEngine(virtual=True, ...)`` gives the same job records
(state, epoch, pool, virtual start and end, runtime, cost) and the same
ordered event stream. The lifecycle table, ``JobState`` and the pricing
catalogs are held equal too, and so is provisioning: the same runtimes fit
the same log-linear models, a profiling sweep through the platform gives
the same training sets, the auto-provisioner makes the same decisions, and
placement fed by a profiler with online feedback places and bills the same
jobs the same way."""
import dataclasses
import importlib
import json
import math
import os
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

TOPICS = ("container_status", "job_progress", "scheduler_metrics")


def _package(name):
    mods = {m: importlib.import_module(f"{name}.core.engine.{m}")
            for m in ("cluster", "events", "lifecycle", "placement",
                      "registry")}
    mods["acai"] = importlib.import_module(f"{name}.core.acai")
    for m in ("autoprovision", "pricing", "profiler"):
        mods[m] = importlib.import_module(f"{name}.core.provision.{m}")
    return types.SimpleNamespace(**mods)


PACKAGES = {name: _package(name) for name in ("repro", "repro_torch")}


class Recorder:
    """Every job's virtual launch times and the virtual time of its last
    terminal event, read from the engine's own launcher and bus."""

    def __init__(self, eng):
        self.eng = eng
        self.starts, self.ends = {}, {}
        terminal = PACKAGES["repro"].lifecycle.TERMINAL_STATUS_VALUES
        launch = eng.launcher.launch

        def stamped(job):
            self.starts.setdefault(job.job_id, []).append(eng.launcher.now)
            launch(job)

        def on_status(msg):
            if msg.get("status") in terminal:
                self.ends[msg["job_id"]] = eng.launcher.now

        eng.launcher.launch = stamped
        eng.bus.subscribe("container_status", on_status)

    def jobs(self):
        return {j.job_id: {
            "name": j.spec.name, "state": j.state.value, "epoch": j.epoch,
            "pool": j.pool, "start": self.starts.get(j.job_id),
            "end": self.ends.get(j.job_id), "runtime": j.runtime,
            "cost": j.cost, "preemptions": j.preemptions,
            "retries": j.retries, "error": j.error,
        } for j in self.eng.registry.all_jobs()}

    def events(self):
        return [(topic, dict(msg)) for topic, msg in self.eng.bus.history]


def _spec(P, name, duration=1.0, user="u", **kw):
    kw.setdefault("resources", {"vcpu": 1.0})
    return P.registry.JobSpec(name=name, project="p", user=user,
                              duration=duration, **kw)


def _drain(eng):
    """Run completions and the fault-tolerance timers on the virtual
    clock until nothing is left."""
    runner, sched = eng.launcher, eng.scheduler
    while True:
        due = [t for t in (runner.next_completion(), sched.next_timer())
               if t is not None]
        if not due:
            return
        if runner.next_completion() == min(due):
            runner.step()
        else:
            runner.advance_to(min(due))
        sched.tick()


def _advance(eng, t):
    """Complete what ends by ``t``, then move the idle clock to it."""
    runner = eng.launcher
    while runner.next_completion() is not None and \
            runner.next_completion() <= t:
        runner.step()
        eng.scheduler.tick()
    runner.advance_to(t)
    eng.scheduler.tick()


def _cluster(P, vcpu, **kw):
    return P.cluster.Cluster({"vcpu": vcpu}, {"vcpu": 0.0}, **kw)


# ---------------------------------------------------------------------------
# scenarios: each drives one package's engine and returns its recorder
# ---------------------------------------------------------------------------


def _policy(P, policy):
    """Two users on 4 vCPUs: a wide job blocks the head, narrow short
    jobs backfill around it, and the policy orders the queues."""
    eng = P.acai.AcaiEngine(virtual=True, cluster=_cluster(P, 4.0),
                            quota_k=10, policy=policy, backfill=True)
    rec = Recorder(eng)
    plan = [("a0", "alice", 6.0, 3.0), ("b0", "bob", 2.0, 2.0),
            ("a1", "alice", 1.0, 4.0), ("b1", "bob", 1.0, 1.0),
            ("a2", "alice", 3.0, 1.0), ("b2", "bob", 8.0, 2.0),
            ("a3", "alice", 1.0, 1.0)]
    for name, user, dur, vcpu in plan:
        eng.submit(_spec(P, name, dur, user, resources={"vcpu": vcpu}))
    _drain(eng)
    return rec


def _dependencies(P, _):
    """A diamond whose middle fails: its child and grandchild cascade
    UPSTREAM_FAILED, the healthy branch finishes."""
    eng = P.acai.AcaiEngine(virtual=True, cluster=_cluster(P, 8.0),
                            quota_k=10)
    rec = Recorder(eng)
    root = eng.submit(_spec(P, "root", 2.0))
    bad = eng.submit(_spec(P, "bad", 5.0, depends_on=[root.job_id]))
    good = eng.submit(_spec(P, "good", 1.0, depends_on=[root.job_id]))
    child = eng.submit(_spec(P, "child", 1.0,
                             depends_on=[bad.job_id, good.job_id]))
    eng.submit(_spec(P, "grandchild", 1.0, depends_on=[child.job_id]))
    eng.submit(_spec(P, "after-good", 1.0, depends_on=[good.job_id]))
    _advance(eng, 3.0)
    assert eng.launcher.fail_running(eng.registry.get(bad.job_id),
                                     "disk full")
    _drain(eng)
    return rec


def _spot(P, _):
    """Two jobs on a spot pool with 5 s checkpoints: a reclaim at t = 12
    preempts both, and each resumes from its last checkpoint."""
    spot = _cluster(P, 2.0, name="spot", spot=True, reclaim_rate=1e-4)
    eng = P.acai.AcaiEngine(
        virtual=True, quota_k=10, pricing={"spot": P.pricing.spot_pricing(
            P.pricing.CPU_PRICING, discount=0.6)},
        placement=P.placement.Placement({"spot": spot}), preemption=True,
        starvation_threshold=1e9, checkpoint_interval=5.0)
    rec = Recorder(eng)
    for i in range(2):
        eng.submit(_spec(P, f"s{i}", 50.0))
    eng.submit(_spec(P, "late", 3.0, resources={"vcpu": 2.0}))
    _advance(eng, 12.0)
    assert len(eng.scheduler.reclaim("spot")) == 2
    _drain(eng)
    assert eng.launcher.preempt_stats["max_lost_s"] <= 5.0 + 1e-9
    return rec


def _catalog(P, _):
    """``default_catalog()`` pools: placement sends vCPU jobs to cpu and
    chip jobs to tpu, and a pin holds."""
    eng = P.acai.AcaiEngine(pricing=P.pricing.default_catalog(),
                            virtual=True, quota_k=10,
                            cluster_nodes={"cpu": 2, "tpu": 1})
    rec = Recorder(eng)
    for i in range(4):
        eng.submit(_spec(P, f"cpu{i}", 1.0 + i, resources={"vcpu": 2}))
    for i in range(3):
        eng.submit(_spec(P, f"tpu{i}", 2.0, resources={"chips": 8}))
    eng.submit(_spec(P, "pinned", 1.0, resources={"vcpu": 1}, pool="cpu"))
    _drain(eng)
    assert {j["pool"] for j in rec.jobs().values()} == {"cpu", "tpu"}
    return rec


def _gang(P, _):
    """A 4-pod gang launches all or nothing on 2-GPU nodes; small jobs
    around it, and a second gang that has to wait."""
    gpu = P.cluster.Cluster({"gpu": 8.0}, {"gpu": 0.0}, name="gpu",
                            node_shape={"gpu": 2.0})
    eng = P.acai.AcaiEngine(virtual=True, quota_k=10,
                            placement=P.placement.Placement({"gpu": gpu}))
    rec = Recorder(eng)
    gang = P.registry.GangSpec
    eng.submit(_spec(P, "small0", 2.0, resources={"gpu": 2.0}))
    eng.submit(_spec(P, "train", 5.0, resources={"gpu": 1.0},
                     gang=gang(n_pods=4)))
    eng.submit(_spec(P, "train2", 3.0, resources={"gpu": 2.0},
                     gang=gang(n_pods=3)))
    eng.submit(_spec(P, "small1", 1.0, resources={"gpu": 1.0}))
    _drain(eng)
    return rec


def _quarantine(P, _):
    """A crash-looping job with a large retry budget is QUARANTINED after
    three fatal failures; a transient-only policy retries its job once."""
    eng = P.acai.AcaiEngine(virtual=True, cluster=_cluster(P, 8.0),
                            quota_k=10, quarantine_threshold=3)
    rec = Recorder(eng)
    retry = P.registry.RetryPolicy
    loop = eng.submit(_spec(P, "loop", 10.0, retry=retry(
        max_retries=10, backoff_base=1.0, retry_on="any")))
    flaky = eng.submit(_spec(P, "flaky", 10.0, retry=retry(
        max_retries=1, backoff_base=0.5)))
    for i in range(3):
        _advance(eng, 2.0 + 3.0 * i)
        assert eng.launcher.fail_running(eng.registry.get(loop.job_id),
                                         f"segfault {i}")
    assert eng.launcher.fail_running(eng.registry.get(flaky.job_id),
                                     "lost node", transient=True)
    _drain(eng)
    assert eng.registry.get(loop.job_id).state.value == "QUARANTINED"
    return rec


def _platform(P, _):
    """Users and tokens through ``AcaiPlatform(virtual=True)``: quota 1
    per (project, user), the admin's queue beside alice's."""
    import tempfile
    plat = P.acai.AcaiPlatform(tempfile.mkdtemp(), virtual=True, quota_k=1)
    admin = plat.create_project(plat.admin_token, "proj")
    alice = plat.create_user(admin, "proj", "alice")
    eng = plat.engine(admin)
    rec = Recorder(eng)
    for i in range(3):
        plat.submit_job(alice, P.registry.JobSpec(
            name=f"a{i}", project="", user="", duration=10.0))
    plat.submit_job(admin, P.registry.JobSpec(name="b", project="",
                                              user="", duration=1.0))
    eng.wait_all()
    tokens = {plat.admin_token: "root", admin: "admin", alice: "alice"}
    rec.users = sorted((tokens[t], dataclasses.asdict(u) | {"token": None})
                       for t, u in plat._users.items())
    return rec


SCENARIOS = {
    "fair": (_policy, "fair"), "fifo": (_policy, "fifo"),
    "dependencies": (_dependencies, None), "spot": (_spot, None),
    "catalog": (_catalog, None), "gang": (_gang, None),
    "quarantine": (_quarantine, None), "platform": (_platform, None),
}


def _both(run, arg):
    return {name: run(P, arg) for name, P in PACKAGES.items()}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scenario_matches_reference(scenario):
    recs = _both(*SCENARIOS[scenario])
    ref, port = recs["repro"], recs["repro_torch"]
    assert port.jobs() == ref.jobs()
    assert port.events() == ref.events()
    assert ref.jobs() and ref.events()
    if scenario == "platform":
        assert port.users == ref.users


def test_scenarios_reach_every_terminal_outcome():
    """The scenarios above cover what they claim, in the port."""
    P = PACKAGES["repro_torch"]
    states = {s: {j["state"] for j in SCENARIOS[s][0](P, SCENARIOS[s][1])
                  .jobs().values()} for s in SCENARIOS}
    assert states["dependencies"] == {"FINISHED", "FAILED",
                                      "UPSTREAM_FAILED"}
    assert states["quarantine"] == {"QUARANTINED", "FINISHED"}
    spot = _spot(P, None).jobs().values()
    assert sorted(j["preemptions"] for j in spot) == [0, 1, 1]
    assert all(j["epoch"] == 1 for j in spot if j["preemptions"])


# ---------------------------------------------------------------------------
# random job streams
# ---------------------------------------------------------------------------

_job = st.tuples(st.integers(0, 2),                 # user
                 st.sampled_from([0.5, 1.0, 2.0, 5.0, 13.0]),  # duration
                 st.sampled_from([0.5, 1.0, 2.0, 4.0]),        # vCPU
                 st.integers(0, 2),                 # priority
                 st.sampled_from([0.0, 0.0, 0.5, 3.0]),        # arrival gap
                 st.integers(-1, 3))                # parent: -1 none, else back


def _stream(P, arg):
    jobs, policy, backfill, fail_at = arg
    eng = P.acai.AcaiEngine(virtual=True, cluster=_cluster(P, 4.0),
                            quota_k=3, policy=policy, backfill=backfill)
    rec = Recorder(eng)
    handles, t = [], 0.0
    for i, (user, dur, vcpu, prio, gap, back) in enumerate(jobs):
        t += gap
        _advance(eng, t)
        deps = [handles[i - 1 - back].job_id] if 0 <= back < i else []
        handles.append(eng.submit(_spec(P, f"j{i}", dur, f"u{user}",
                                        resources={"vcpu": vcpu},
                                        priority=prio, depends_on=deps)))
        if fail_at == i:
            running = [j for j in eng.registry.all_jobs()
                       if j.state.value == "RUNNING"]
            if running:
                eng.launcher.fail_running(running[0], "injected")
    _drain(eng)
    return rec


@settings(max_examples=50, deadline=2000, derandomize=True, database=None)
@given(jobs=st.lists(_job, min_size=1, max_size=14),
       policy=st.sampled_from(["fair", "fifo"]), backfill=st.booleans(),
       fail_at=st.integers(-1, 13))
def test_random_job_streams_match_reference(jobs, policy, backfill,
                                            fail_at):
    recs = _both(_stream, (jobs, policy, backfill, fail_at))
    ref, port = recs["repro"], recs["repro_torch"]
    assert port.jobs() == ref.jobs()
    assert port.events() == ref.events()
    assert all(j["state"] in ("FINISHED", "FAILED", "UPSTREAM_FAILED")
               for j in port.jobs().values())


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


def test_lifecycle_table_and_states_match_reference():
    ref, port = PACKAGES["repro"].lifecycle, PACKAGES["repro_torch"].lifecycle
    assert [(s.name, s.value) for s in port.JobState] == \
        [(s.name, s.value) for s in ref.JobState]

    def table(mod):
        return {k.value: sorted(v.value for v in vs)
                for k, vs in mod._TRANSITIONS.items()}

    assert table(port) == table(ref)
    for name in ("ACTIVE_STATES", "TERMINAL_STATES"):
        assert {s.value for s in getattr(port, name)} == \
            {s.value for s in getattr(ref, name)}
    assert port.TERMINAL_STATUS_VALUES == ref.TERMINAL_STATUS_VALUES
    for old in port.JobState:
        for new in port.JobState:
            legal = new.value in table(ref)[old.value]
            try:
                port.check_transition(old, new)
                assert legal
            except port.IllegalTransition:
                assert not legal


def _catalog_rows(mod):
    return {fam: (type(p).__name__, p.family,
                  [dataclasses.astuple(d) for d in p.dims.values()])
            for fam, p in {**mod.default_catalog(),
                           "cpu-spot": mod.spot_pricing(mod.CPU_PRICING),
                           "tpu-spot": mod.spot_pricing(mod.TPU_PRICING,
                                                        0.7)}.items()}


def test_pricing_catalogs_match_reference():
    ref, port = PACKAGES["repro"].pricing, PACKAGES["repro_torch"].pricing
    assert _catalog_rows(port) == _catalog_rows(ref)
    for name in ("CPU_PRICING", "TPU_PRICING"):
        r, p = getattr(ref, name), getattr(port, name)
        assert p.grid() == r.grid()
        for res in r.grid()[::7]:
            assert p.job_cost(res, 1234.5) == r.job_cost(res, 1234.5)


def test_durable_engine_recovers_its_jobs(tmp_path):
    """``durable=`` journals the engine: a second engine over the same
    state, after the first died mid-run, adopts the finished job as it was
    and re-queues the running one as a new epoch, as the reference's
    does."""
    out = {}
    for name, P in PACKAGES.items():
        def engine():
            return P.acai.AcaiEngine(virtual=True, durable=tmp_path / name,
                                     cluster=_cluster(P, 2.0), quota_k=10)
        eng = engine()
        done = eng.submit(_spec(P, "done", 2.0))
        running = eng.submit(_spec(P, "running", 50.0))
        eng.launcher.step()
        assert running.job.state.value == "RUNNING"
        eng.store.close()
        eng2 = engine()
        rep = eng2.recovery
        _drain(eng2)
        jobs = [eng2.registry.get(h.job_id) for h in (done, running)]
        out[name] = ((rep.jobs_total, rep.terminal, rep.requeued),
                     [(j.state.value, j.epoch, j.runtime, j.cost)
                      for j in jobs])
        eng2.store.close()
    assert out["repro_torch"] == out["repro"]
    assert out["repro_torch"][0] == (2, 1, 1)
    assert [j[:2] for j in out["repro_torch"][1]] == [("FINISHED", 0),
                                                      ("FINISHED", 1)]


def test_subprocess_runner_runs_a_job(tmp_path):
    """``runner="subprocess"`` runs a job in a worker process of its own,
    which exits when the runner shuts it down."""
    P = PACKAGES["repro_torch"]
    jobs = importlib.import_module("repro_torch.core.engine.durable.jobs")
    eng = P.acai.AcaiEngine(runner="subprocess",
                            workroot=str(tmp_path / "w"))
    h = eng.submit(P.registry.JobSpec(
        name="e", project="p", user="u", fn=jobs.echo_job,
        args={"msg": "hi"}, resources={"vcpu": 1.0}))
    try:
        assert h.wait(timeout=60).value == "FINISHED", h.job.error
        pid = eng.launcher._worker_pid()
    finally:
        eng.launcher.shutdown()
    assert h.job.outputs["echo"] == "hi"
    assert h.job.outputs["log"] == "echo: hi\n"
    assert pid is not None and pid != os.getpid()
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        try:
            if os.waitpid(pid, os.WNOHANG)[0] == pid:
                break
        except ChildProcessError:
            break               # reaped already
        time.sleep(0.05)
    else:
        raise AssertionError(f"worker {pid} still alive after shutdown")


# ---------------------------------------------------------------------------
# provisioning: profiler, log-linear model, auto-provisioner, placement
# ---------------------------------------------------------------------------


def _same(port, ref):
    """Equal to the last bit, NaN included (json writes each float with
    its shortest exact repr)."""
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)


def _oracle_runtime(cfg, noise=0.0):
    """t = t1 * epochs * c^-0.9 * m^-0.05 (the paper's Fig. 10 shape),
    with a deterministic multiplicative noise drawn from the config."""
    t = 120.0 * cfg["epoch"] * cfg["vcpu"] ** -0.9 * \
        (cfg["mem_mb"] / 512.0) ** -0.05
    if noise:
        seed = int(cfg["epoch"] * 1e6 + cfg["vcpu"] * 1e3 + cfg["mem_mb"])
        t *= math.exp(np.random.default_rng(seed).normal(0, noise))
    return t


def _wall_oracle(cfg):
    """1/chips scaling up to a collective wall at 2 s a step."""
    return cfg["steps"] * max(600.0 / cfg["chips"], 2.0)


def _templates(P):
    T = P.profiler.CommandTemplate
    return {"mnist": T("mnist", {"epoch": [1, 2, 3]},
                       {"vcpu": [0.5, 1, 2], "mem_mb": [512, 1024, 2048]}),
            "walled": T("walled", {"steps": [10, 20]},
                        {"chips": [8, 32, 128], "hbm_gb": [4, 16]})}


def _model_state(model):
    return {"features": model.feature_names, "clamp": model.clamp,
            "coef": model.coef.tolist(), "f_lo": model._f_lo.tolist(),
            "f_hi": model._f_hi.tolist(), "y": [model._y_lo, model._y_hi]}


def _profiler_state(prof):
    return {"models": {n: _model_state(m) for n, m in prof.models.items()},
            "training": prof.training_sets, "last": prof.last_source}


EVAL_CFGS = [{"epoch": e, "vcpu": c, "mem_mb": m}
             for e in (1, 5, 20) for c in (0.5, 1, 4, 8)
             for m in (512, 2048, 8192)]


def _fit(P, noise):
    tmpl = _templates(P)["mnist"]
    grid = tmpl.grid()
    true = [_oracle_runtime(c, noise) for c in grid]
    LL = P.profiler.LogLinearModel
    model = LL(tmpl.feature_names).fit(grid, true)
    weighted = LL(tmpl.feature_names, clamp=True).fit(
        grid, true, weights=[0.5 ** (i / 4) for i in range(len(grid))])
    evals = [_oracle_runtime(c, noise) for c in EVAL_CFGS]
    pred = model.predict_many(EVAL_CFGS)
    return {
        "model": _model_state(model), "weighted": _model_state(weighted),
        "predict": [model.predict(c) for c in EVAL_CFGS],
        "predict_clamped": [model.predict(c, clamp=True) for c in EVAL_CFGS],
        "predict_many": pred.tolist(),
        "weighted_predict": weighted.predict_many(EVAL_CFGS).tolist(),
        "in_hull": [model.in_hull(c) for c in EVAL_CFGS],
        "errors": LL.errors(pred, np.array(evals)),
    }


@pytest.mark.parametrize("noise", [0.0, 0.05, 0.1])
def test_loglinear_model_matches_reference(noise):
    """Fit, weighted fit, raw and clamped predictions, hull test and
    error metrics on the paper's grid, exact and noisy."""
    got = {name: _fit(P, noise) for name, P in PACKAGES.items()}
    _same(got["repro_torch"], got["repro"])
    if not noise:     # the model family holds the oracle: exact recovery
        far = EVAL_CFGS.index({"epoch": 20, "vcpu": 8, "mem_mb": 8192})
        assert got["repro_torch"]["predict"][far] == pytest.approx(
            _oracle_runtime(EVAL_CFGS[far]), rel=1e-6)


def _sweep(P, quorum):
    """The paper's profiling sweep through ``AcaiPlatform(virtual=True)``:
    one virtual job per grid point, a quorum, then the fit."""
    import tempfile
    plat = P.acai.AcaiPlatform(
        tempfile.mkdtemp(), virtual=True, quota_k=4,
        oracle=lambda job: _oracle_runtime(job.spec.args, noise=0.1))
    admin = plat.create_project(plat.admin_token, "proj")
    rec = Recorder(plat.engine(admin))
    prof = plat.make_profiler(admin, quorum=quorum, priority=2)

    def job_factory(cfg):
        return P.registry.JobSpec(
            name="prof", project="", user="", args=cfg,
            resources={k: cfg[k] for k in ("vcpu", "mem_mb")})

    model = prof.profile(_templates(P)["mnist"], job_factory)
    return rec, prof, [model.predict(c) for c in EVAL_CFGS]


@pytest.mark.parametrize("quorum", [0.95, 0.5])
def test_profiling_sweep_through_platform_matches_reference(quorum):
    """The same sweep gives the same job records, events, training set,
    fitted model and predictions; the quorum stops the sweep before its
    slowest runs in both."""
    got = {name: _sweep(P, quorum) for name, P in PACKAGES.items()}
    (rrec, rprof, rpred), (prec, pprof, ppred) = \
        got["repro"], got["repro_torch"]
    assert prec.jobs() == rrec.jobs()
    assert prec.events() == rrec.events()
    _same(_profiler_state(pprof), _profiler_state(rprof))
    _same(ppred, rpred)
    n = len(pprof.training_sets["mnist"][0])
    assert math.ceil(quorum * 27) <= n < 27      # the quorum cut the sweep


def _baseline(P):
    pricing = P.pricing.CPU_PRICING
    base = {"vcpu": 2.0, "mem_mb": 7680}
    t = _oracle_runtime({"epoch": 20, **base})
    return t, pricing.job_cost(base, t)


def _provision(P, case):
    """One auto-provisioner decision (or refinement) on a profiler fit
    offline; returns the decision, any history and the profiler after."""
    prof = P.profiler.Profiler(engine=None)
    tmpls = _templates(P)
    name = "walled" if case.startswith("refined") else "mnist"
    grid = tmpls[name].grid()
    oracle = _wall_oracle if name == "walled" else _oracle_runtime
    prof.fit_offline(tmpls[name], grid, [oracle(c) for c in grid])
    AP, pr = P.autoprovision.AutoProvisioner, P.pricing
    t_base, c_base = _baseline(P)
    hist = None
    if case == "runtime-under-cost":
        dec = AP(prof, pr.CPU_PRICING).optimize_runtime(
            "mnist", {"epoch": 20}, max_cost=c_base)
    elif case == "cost-under-runtime":
        dec = AP(prof, pr.CPU_PRICING).optimize_cost(
            "mnist", {"epoch": 20}, max_runtime=t_base)
    elif case == "infeasible":
        dec = AP(prof, pr.CPU_PRICING).optimize_runtime(
            "mnist", {"epoch": 20}, max_cost=1e-9)
    elif case.startswith("random-pricing"):
        rng = np.random.default_rng(int(case[-1]))
        pricing = pr.Pricing([
            pr.ResourceDim("vcpu", 0.5, 8.0, float(rng.uniform(0.01, 0.1)),
                           tuple(np.arange(0.5, 8.5, 0.5))),
            pr.ResourceDim("mem_mb", 512, 8192,
                           float(rng.uniform(1e-6, 1e-5)),
                           tuple(range(512, 8448, 256)))])
        dec = AP(prof, pricing).optimize_runtime(
            "mnist", {"epoch": 5}, max_cost=float(rng.uniform(0.001, 0.2)))
    elif case.startswith("catalog"):
        # per-pool models: the tpu pool runs the template 4x faster
        cpu_t, tpu_t = (P.profiler.CommandTemplate(
            f"mnist@{pool}", {"epoch": [1, 2, 3]}, res)
            for pool, res in (("cpu", {"vcpu": [0.5, 2.0],
                                       "mem_mb": [512.0, 2048.0]}),
                              ("tpu", {"chips": [8.0, 16.0]})))
        prof.fit_offline(cpu_t, cpu_t.grid(),
                         [60.0 * c["epoch"] / c["vcpu"]
                          for c in cpu_t.grid()])
        prof.fit_offline(tpu_t, tpu_t.grid(),
                         [15.0 * c["epoch"] * 8.0 / c["chips"]
                          for c in tpu_t.grid()])
        ap = AP(prof, {"cpu": pr.CPU_PRICING, "tpu": pr.TPU_PRICING})
        dec = ap.optimize_cost("mnist", {"epoch": 20}, max_runtime=1e6) \
            if case == "catalog-cost" else \
            ap.optimize_runtime("mnist", {"epoch": 20}, max_cost=1e6)
    elif case == "refined-wall":
        base = {"chips": 32, "hbm_gb": 16}
        t = _wall_oracle({"steps": 100, **base})
        dec, hist = AP(prof, pr.TPU_PRICING).refined_search(
            "walled", {"steps": 100}, measure_fn=_wall_oracle,
            objective="runtime",
            max_cost=pr.TPU_PRICING.job_cost(base, t), rounds=4)
    return {"decision": dataclasses.asdict(dec), "feasible": dec.feasible,
            "history": hist, "profiler": _profiler_state(prof)}


PROVISION_CASES = ["runtime-under-cost", "cost-under-runtime", "infeasible",
                   "random-pricing-0", "random-pricing-1", "random-pricing-2",
                   "catalog-cost", "catalog-runtime", "refined-wall"]


@pytest.mark.parametrize("case", PROVISION_CASES)
def test_autoprovisioner_matches_reference(case):
    """The same constrained search gives the same decision, the same full
    search table and, for refinement, the same history and refit."""
    got = {name: _provision(P, case) for name, P in PACKAGES.items()}
    _same(got["repro_torch"], got["repro"])
    port = got["repro_torch"]
    assert port["feasible"] == (case != "infeasible")
    if case.startswith("catalog"):
        assert port["decision"]["pool"] == \
            ("cpu" if case == "catalog-cost" else "tpu")
    if case == "refined-wall":
        assert port["history"] and port["history"][-1]["rel_err"] <= 0.10


class _Prior:
    """A duck-typed cold-start prior (the reference's ``RooflinePrior``
    interface): it estimates the ``cold`` template on either pool."""

    def can_estimate(self, template, pool):
        return template == "cold"

    def estimate(self, template, pool, config):
        return config["work"] / (8.0 if pool == "tpu" else 1.0)


def _placed(P, objective):
    """A two-pool engine from the catalog whose placement reads a
    profiler: a fitted template, a prior-only template and an unknown one,
    submitted in waves, with every FINISHED runtime fed back into the
    per-pool models."""
    pr = P.pricing
    catalog = {"cpu": pr.CPU_PRICING, "tpu": pr.TPU_PRICING}

    def oracle(job):
        w = job.spec.args["work"]
        return w * (0.2 if job.pool == "tpu" else 1.0) + 1.0

    eng = P.acai.AcaiEngine(virtual=True, pricing=catalog, quota_k=100,
                            cluster_nodes={"cpu": 1, "tpu": 1},
                            placement_objective=objective, oracle=oracle)
    rec = Recorder(eng)
    prof = P.profiler.Profiler(engine=None, prior=_Prior(),
                               recency_halflife=3.0)
    T = P.profiler.CommandTemplate
    for pool, res, speed in (("cpu", {"vcpu": [1.0, 4.0]}, 1.0),
                             ("tpu", {"chips": [8.0, 16.0]}, 4.0)):
        t = T(f"warm@{pool}", {"work": [10.0, 40.0, 160.0]}, res)
        prof.fit_offline(t, t.grid(), [c["work"] / speed
                                       for c in t.grid()])
    eng.use_profiler(prof, feedback=True)
    shapes = {"cpu": {"vcpu": 4.0, "mem_mb": 1024.0},
              "tpu": {"chips": 8.0, "hbm_gb": 4.0}}
    for wave in range(3):
        for i, (tmpl, work) in enumerate([("warm", 20.0), ("cold", 30.0),
                                          ("warm", 300.0), ("cold", 5.0),
                                          (None, 12.0)]):
            eng.submit(P.registry.JobSpec(
                name=f"w{wave}-{i}", project="p", user=f"u{i % 2}",
                template=tmpl, args={"work": work + wave},
                duration=None if tmpl else 3.0,
                pool_resources=shapes))
        _advance(eng, 50.0 * (wave + 1))
    _drain(eng)
    return rec, prof, eng.scheduler.placement.stats


@pytest.mark.parametrize("objective", ["cost", "runtime"])
def test_profiler_fed_placement_with_feedback_matches_reference(objective):
    """Placement scored by fitted per-pool models, the duck-typed prior
    and declared durations: the same pools, starts, runtimes and bills,
    the same events, the same learned models and the same source counts."""
    got = {name: _placed(P, objective) for name, P in PACKAGES.items()}
    (rrec, rprof, rstats), (prec, pprof, pstats) = \
        got["repro"], got["repro_torch"]
    assert prec.jobs() == rrec.jobs()
    assert prec.events() == rrec.events()
    _same(_profiler_state(pprof), _profiler_state(rprof))
    assert pstats == rstats
    # every source was used, and feedback grew models for both templates
    assert all(pstats[s] > 0 for s in ("predictor", "prior", "declared"))
    assert set(pprof.models) == {"cold@cpu", "cold@tpu", "warm@cpu",
                                 "warm@tpu"}
    assert len(pprof.training_sets["warm@tpu"][1]) > 6   # 6 fit offline
    assert {j["pool"] for j in prec.jobs().values()} == {"cpu", "tpu"}
    assert all(j["state"] == "FINISHED" for j in prec.jobs().values())
