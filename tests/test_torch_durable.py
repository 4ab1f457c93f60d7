"""The port's durable control plane (``repro_torch.core.engine.durable``:
store, codec, journal, recovery, the subprocess runner and its worker, the
crash drill), chaos injection (``faults.py``), elastic pools, the dashboard,
workflow replay and the fileset cache, against the reference's
(``repro.core``) on the CPU.

The same job streams through each package's durable engine write the same
journal and snapshot records and recover into the same ``RecoveryReport``
and job records; the wall-clock fields (a job's ``submitted_at``,
``started_at`` and ``finished_at``, a recovery's ``wall_s``) are left out,
and a job fn is compared by its qualname, since its module names the
package. The port also passes the reference's own recovery, subprocess
runner and platform-extras cases, and fixes two faults of the reference's
subprocess runner that show on the CPU (ROADMAP C): the logs of
overlapping jobs mix, and ``[[acai:...]]`` metrics never reach the metadata
store. The third, dispatch timing, needs a card
(``tests/test_torch_card.py::test_subprocess_runner_runtime_covers_queued_device_work``).

Every test that spawns a worker process shuts it down, and the ``spawned``
fixture fails a test that leaves one of its workers alive."""
import dataclasses
import importlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from hypothesis import example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOPIC = "container_status"


def _package(name):
    mods = {m: importlib.import_module(f"{name}.core.engine.{m}")
            for m in ("dashboard", "events", "faults", "launcher",
                      "lifecycle", "registry", "replay", "scheduler",
                      "monitor", "cluster")}
    for m in ("drill", "jobs", "journal", "recovery", "runner", "store",
              "codec", "worker"):
        mods[m] = importlib.import_module(f"{name}.core.engine.durable.{m}")
    mods["acai"] = importlib.import_module(f"{name}.core.acai")
    mods["cache"] = importlib.import_module(f"{name}.core.datalake.cache")
    mods["elastic"] = importlib.import_module(
        f"{name}.core.provision.elastic")
    mods["pricing"] = importlib.import_module(
        f"{name}.core.provision.pricing")
    return types.SimpleNamespace(name=name, **mods)


PACKAGES = {name: _package(name) for name in ("repro", "repro_torch")}
REF, PORT = PACKAGES["repro"], PACKAGES["repro_torch"]


@pytest.fixture
def spawned(monkeypatch):
    """Every worker process the runners of either package spawn during the
    test; at its end each must have exited (within 15 s of the test's
    end), and one that has not is killed and fails the test."""
    procs = []
    real = subprocess.Popen

    def popen(*args, **kw):
        proc = real(*args, **kw)
        procs.append(proc)
        return proc

    for P in PACKAGES.values():
        monkeypatch.setattr(P.runner, "subprocess", types.SimpleNamespace(
            Popen=popen, STDOUT=subprocess.STDOUT))
    yield procs
    alive = []
    for proc in procs:
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            alive.append(proc.pid)
            proc.kill()
            proc.wait(timeout=15)
    assert not alive, f"worker processes still alive: {alive}"


# ---------------------------------------------------------------------------
# normalising records: wall-clock fields out, fn references by qualname
# ---------------------------------------------------------------------------

_WALL = ("at", "submitted_at", "started_at", "finished_at", "wall_s")


def _norm(obj):
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k in _WALL:
                continue
            if k == "fn" and isinstance(v, str):
                v = v.partition(":")[2]
            out[k] = _norm(v)
        return out
    if isinstance(obj, (list, tuple)):
        return [_norm(v) for v in obj]
    return obj


def _report(rep):
    return _norm(dataclasses.asdict(rep)) if rep is not None else None


def _records(eng):
    return {j.job_id: _norm(_codec(eng).encode_job(j))
            for j in eng.registry.all_jobs()}


def _codec(eng):
    return REF.codec if type(eng).__module__.startswith("repro.") \
        else PORT.codec


def _underflow(eng) -> int:
    return sum(cl.stats["release_underflow"]
               for cl in eng.scheduler.pools.values())


def _venv(P, state_dir, **kw):
    """The reference recovery tests' engine: durable, virtual, one 8-vCPU
    node, preemption with 10 s checkpoints."""
    kw.setdefault("virtual", True)
    kw.setdefault("pricing", P.pricing.CPU_PRICING)
    kw.setdefault("cluster_nodes", 1)
    kw.setdefault("quota_k", 100)
    kw.setdefault("preemption", True)
    kw.setdefault("checkpoint_interval", 10.0)
    return P.acai.AcaiEngine(durable=state_dir, **kw)


def _vspec(P, name, duration, vcpu=2.0, priority=0, depends_on=(), **kw):
    return P.registry.JobSpec(name=name, project="p", user="u",
                              duration=duration, priority=priority,
                              resources={"vcpu": vcpu, "mem_mb": 512.0},
                              depends_on=list(depends_on), **kw)


def _drain(eng):
    launcher = eng.scheduler.launcher
    while launcher.pending():
        launcher.step()


# ---------------------------------------------------------------------------
# journal and codec: hypothesis job streams, record for record
# ---------------------------------------------------------------------------

_submit = st.tuples(st.just("submit"),
                    st.sampled_from([2.0, 5.0, 20.0, 60.0]),
                    st.sampled_from([1.0, 2.0, 4.0, 8.0]), st.integers(0, 2),
                    st.integers(-1, 3), st.booleans())
_op = st.one_of(                     # submits and steps drawn more often
    _submit, _submit, _submit,
    st.tuples(st.just("step")), st.tuples(st.just("step")),
    st.tuples(st.just("preempt"), st.integers(0, 15)),
    st.tuples(st.just("resize"), st.sampled_from([4.0, 6.0, 8.0])),
    st.tuples(st.just("fail"), st.integers(0, 15), st.booleans()),
    st.tuples(st.just("kill"), st.integers(0, 15)),
)


def _running(eng):
    return sorted((j for j in eng.registry.all_jobs()
                   if j.state.value == "RUNNING"), key=lambda j: j.job_id)


def _journal_stream(P, ops, snapshot_every, state_dir):
    """Drive the ops through a durable virtual engine, crash it (store
    closed, no snapshot), recover a second engine over the same state and
    drain it. Returns every record appended and every key put, the
    recovery's report and the final job records."""
    eng = _venv(P, state_dir, snapshot_every=snapshot_every)
    seen = []

    def tap(store):
        append, put = store.append, store.put
        store.append = lambda s, r: (seen.append(("append", s, r)),
                                     append(s, r))[1]
        store.put = lambda k, o: (seen.append(("put", k, o)), put(k, o))[1]

    tap(eng.store)
    pool = next(iter(eng.scheduler.pools))
    handles = []
    for op in ops:
        kind = op[0]
        if kind == "submit":
            _, dur, vcpu, prio, back, retry = op
            i = len(handles)
            deps = [handles[i - 1 - back].job_id] if 0 <= back < i else []
            kw = {"retry": P.registry.RetryPolicy(max_retries=2,
                                                  backoff_base=0.0)} \
                if retry else {}
            handles.append(eng.submit(_vspec(
                P, f"j{i}", dur, vcpu, prio, deps, fn=P.jobs.echo_job,
                **kw)))
        elif kind == "step":
            if eng.launcher.pending():
                eng.launcher.step()
                eng.scheduler.tick()
        elif kind == "preempt":
            run = _running(eng)
            if run:
                eng.scheduler.preempt(run[op[1] % len(run)].job_id)
        elif kind == "resize":
            eng.scheduler.resize_pool(pool, {"vcpu": op[1]})
        elif kind == "fail":
            run = _running(eng)
            if run:
                eng.launcher.fail_running(run[op[1] % len(run)], "flake",
                                          transient=op[2])
        elif kind == "kill" and handles:
            eng.scheduler.kill(handles[op[1] % len(handles)].job_id)
    eng.store.close()
    eng2 = _venv(P, state_dir, snapshot_every=snapshot_every)
    tap(eng2.store)
    rep = eng2.recovery
    eng2.scheduler.resize_pool(pool, {"vcpu": 8.0})
    _drain(eng2)
    final = _records(eng2)
    eng2.store.close()
    return _norm(seen), _report(rep), final, _underflow(eng2)


@settings(max_examples=30, deadline=5000, derandomize=True, database=None)
@given(ops=st.lists(_op, min_size=1, max_size=24),
       snapshot_every=st.sampled_from([0, 5]))
# a preempted job resumed from its checkpoint after the crash, a kill, and
# a dependent job; a transient failure retried under its budget
@example(ops=[("submit", 60.0, 4.0, 0, -1, True),
              ("submit", 20.0, 2.0, 0, -1, False),
              ("submit", 5.0, 8.0, 1, 0, False), ("step",), ("preempt", 0),
              ("fail", 1, True), ("submit", 60.0, 4.0, 2, -1, False),
              ("kill", 2)], snapshot_every=5)
@example(ops=[("submit", 20.0, 4.0, 0, -1, True), ("fail", 0, True),
              ("submit", 5.0, 2.0, 0, 0, False)], snapshot_every=0)
def test_journal_and_snapshots_match_reference(ops, snapshot_every):
    out = {}
    for name, P in PACKAGES.items():
        with tempfile.TemporaryDirectory() as d:
            out[name] = _journal_stream(P, ops, snapshot_every,
                                        Path(d) / "state")
    ref, port = out["repro"], out["repro_torch"]
    assert port[0] == ref[0]              # every record and snapshot
    assert port[1] == ref[1]              # the recovery report
    assert port[2] == ref[2]              # the final job records
    assert port[3] == ref[3] == 0         # exactly-once release
    if any(op[0] == "submit" for op in ops):
        assert any(s == "journal" for _, s, _r in port[0])
        assert all(r["state"] in ("FINISHED", "FAILED", "KILLED",
                                  "UPSTREAM_FAILED", "QUARANTINED")
                   for r in port[2].values())


def _spec_docs(P):
    gang = P.registry.GangSpec(n_pods=4, per_pod_resources={"gpu": 2.0},
                               topology="ring", min_pods=2)
    retry = P.registry.RetryPolicy(max_retries=5, backoff_base=2.0,
                                   backoff_cap=30.0, retry_on="any")
    return [
        P.registry.JobSpec(name="a", project="p", user="u",
                           fn=P.jobs.sleep_job, args={"seconds": 0.5},
                           resources={"vcpu": 2.0}, priority=3),
        P.registry.JobSpec(name="b", project="p", user="u", duration=7.5,
                           gang=gang, retry=retry, timeout_s=60.0,
                           deadline=900.0, depends_on=["job-1"],
                           pool_resources={"gpu": {"gpu": 2.0}},
                           input_bytes=1e9, template="t", pool="gpu"),
        P.registry.JobSpec(name="c", project="p", user="u",
                           fn=lambda w, j: {}, args={"x": float("nan")}),
    ]


def test_codec_round_trips_like_reference():
    for (rs, ps) in zip(_spec_docs(REF), _spec_docs(PORT)):
        rdoc, pdoc = REF.codec.encode_spec(rs), PORT.codec.encode_spec(ps)
        assert _norm(pdoc) == _norm(rdoc)
        back = PORT.codec.decode_spec(pdoc)
        assert _norm(PORT.codec.encode_spec(back)) == _norm(pdoc)
    assert PORT.codec.encode_fn(lambda: 0) is None
    assert PORT.codec.decode_fn("no.such.module:fn").__qualname__ == \
        "<unresolvable>"
    plan = PORT.faults.FaultPlan(seed=3, node_mtbf_s=5.0,
                                 max_node_failures=2)
    assert PORT.codec.decode_fault_plan(
        PORT.codec.encode_fault_plan(plan)) == plan
    assert PORT.codec.encode_fault_plan(plan) == REF.codec.encode_fault_plan(
        REF.faults.FaultPlan(seed=3, node_mtbf_s=5.0, max_node_failures=2))
    for P in PACKAGES.values():
        model = importlib.import_module(
            f"{P.name}.core.engine.placement").TransferCostModel(
            cost_per_gb=0.02, pair_cost_per_gb={("a", "b"): 0.5})
        doc = P.codec.encode_transfer_costs(model)
        assert P.codec.decode_transfer_costs(doc) == model
    assert PORT.codec.encode_transfer_costs(
        PORT.codec.decode_transfer_costs(doc)) == doc


@pytest.mark.parametrize("name", ["MemoryStore", "FileStore"])
def test_stores_match_reference(name, tmp_path):
    stores = {}
    for pkg, P in PACKAGES.items():
        cls = getattr(P.store, name)
        s = cls(tmp_path / pkg) if name == "FileStore" else cls()
        s.append("j", {"a": 1, "b": float("inf")})
        s.append("j", {"a": 2})
        s.put("snap", {"seq": 2, "x": [1, 2]})
        stores[pkg] = s
    ref, port = stores["repro"], stores["repro_torch"]
    assert port.read("j") == ref.read("j")
    assert port.get("snap") == ref.get("snap")
    port.truncate("j")
    port.delete("snap")
    assert port.read("j") == [] and port.get("snap") is None
    if name == "FileStore":
        # a torn tail (a crash mid-append) is dropped on read
        port.append("j", {"a": 3})
        port.close()
        with (tmp_path / "repro_torch" / "j.jsonl").open("a") as fh:
            fh.write('{"a": 4, "tor')
        assert port.read("j") == [{"a": 3}]
        ref.close()


# ---------------------------------------------------------------------------
# recovery: the reference's cases, in both packages
# ---------------------------------------------------------------------------


def _mixed(P, d):
    eng = _venv(P, d)
    h_done = eng.submit(_vspec(P, "done", duration=5.0))
    h_long = eng.submit(_vspec(P, "long", duration=100.0, vcpu=4.0))
    h_parent = eng.submit(_vspec(P, "parent", duration=50.0, vcpu=2.0))
    h_held = eng.submit(_vspec(P, "held", duration=5.0,
                               depends_on=[h_parent.job_id]))
    h_queued = eng.submit(_vspec(P, "queued", duration=5.0, vcpu=8.0))
    eng.scheduler.launcher.step()
    eng.submit(_vspec(P, "filler", duration=25.0, vcpu=2.0))
    eng.scheduler.launcher.step()
    assert eng.scheduler.preempt(h_long.job_id)
    assert eng.registry.get(h_held.job_id).state.value == "QUEUED"
    eng.store.close()
    eng2 = _venv(P, d)
    rep = eng2.recovery
    assert (rep.jobs_total, rep.terminal, rep.requeued, rep.resumed) == \
        (6, 2, 4, 1)
    assert eng2.registry.get(h_long.job_id).epoch == 2
    _drain(eng2)
    for h in (h_done, h_long, h_parent, h_held, h_queued):
        assert eng2.registry.get(h.job_id).state.value == "FINISHED"
    assert eng2.registry.get(h_long.job_id).runtime == 70.0
    assert eng2.scheduler.stats["completed"] == 4
    return rep, eng2


def _gating(P, d):
    eng = _venv(P, d)
    ok = eng.submit(_vspec(P, "ok-parent", duration=50.0, vcpu=4.0))
    ok_child = eng.submit(_vspec(P, "ok-child", duration=5.0,
                                 depends_on=[ok.job_id]))
    bad = eng.submit(_vspec(P, "bad-parent", duration=50.0, vcpu=4.0))
    bad_child = eng.submit(_vspec(P, "bad-child", duration=5.0,
                                  depends_on=[bad.job_id]))
    eng.store.close()
    eng2 = _venv(P, d)
    eng2.scheduler.kill(bad.job_id)
    _drain(eng2)
    states = {h.job_id: eng2.registry.get(h.job_id).state.value
              for h in (ok, ok_child, bad, bad_child)}
    assert list(states.values()) == ["FINISHED", "FINISHED", "KILLED",
                                     "UPSTREAM_FAILED"]
    return eng2.recovery, eng2


def _duplicates(P, d):
    eng = _venv(P, d)
    hs = [eng.submit(_vspec(P, "a", duration=5.0)),
          eng.submit(_vspec(P, "b", duration=8.0))]
    _drain(eng)
    eng.store.close()
    jpath = d / f"{P.journal.JOURNAL_STREAM}.jsonl"
    jpath.write_text(jpath.read_text() + jpath.read_text())
    eng2 = _venv(P, d)
    assert (eng2.recovery.terminal, eng2.recovery.requeued) == (2, 0)
    for h in hs:
        job = eng2.registry.get(h.job_id)
        assert (job.state.value, job.epoch) == ("FINISHED", 0)
    assert eng2.scheduler.stats["completed"] == 0
    return eng2.recovery, eng2


def _stale_epoch(P, d):
    eng = _venv(P, d)
    h = eng.submit(_vspec(P, "a", duration=100.0))
    eng.store.close()
    eng2 = _venv(P, d)
    job = eng2.registry.get(h.job_id)
    assert (job.epoch, job.state.value) == (1, "RUNNING")
    eng2.bus.publish(TOPIC, {"job_id": h.job_id, "epoch": 0,
                             "status": "FINISHED"})
    assert eng2.registry.get(h.job_id).state.value == "RUNNING"
    assert eng2.scheduler.stats["completed"] == 0
    _drain(eng2)
    assert eng2.registry.get(h.job_id).state.value == "FINISHED"
    assert eng2.scheduler.stats["completed"] == 1
    return eng2.recovery, eng2


def _resize(P, d):
    eng = _venv(P, d)
    pool = next(iter(eng.scheduler.pools))
    eng.scheduler.resize_pool(pool, {"vcpu": 5.0})
    eng.store.close()
    eng2 = _venv(P, d)
    assert eng2.scheduler.pools[pool].capacity["vcpu"] == 5.0
    return eng2.recovery, eng2


def _retry_counters(P, d):
    eng = _venv(P, d, preemption=False, checkpoint_interval=None)
    h = eng.submit(_vspec(P, "r", duration=20.0, vcpu=4.0,
                          retry=P.registry.RetryPolicy(max_retries=3,
                                                       backoff_base=500.0)))
    job = eng.registry.get(h.job_id)
    eng.scheduler.launcher.advance_to(5.0)
    assert eng.scheduler.launcher.fail_running(job, "node blip",
                                               transient=True)
    eng.store.close()
    eng2 = _venv(P, d, preemption=False, checkpoint_interval=None)
    assert eng2.registry.get(h.job_id).retries == 1
    _drain(eng2)
    assert eng2.registry.get(h.job_id).state.value == "FINISHED"
    return eng2.recovery, eng2


def _wait_persisted(P, d):
    eng = _venv(P, d)
    h = eng.submit(_vspec(P, "a", duration=5.0))
    eng.scheduler.launcher.step()
    eng.store.close()
    eng2 = _venv(P, d)
    assert eng2.monitor.wait_terminal(h.job_id, timeout=1.0)
    h2 = P.acai.JobHandle(eng2.registry.get(h.job_id), eng2)
    assert h2.wait(timeout=1.0).value == "FINISHED"
    assert not eng2.monitor.wait_terminal("job-404", timeout=0.05)
    return eng2.recovery, eng2


RECOVERY_CASES = {"mixed": _mixed, "gating": _gating,
                  "duplicates": _duplicates, "stale_epoch": _stale_epoch,
                  "resize": _resize, "retry_counters": _retry_counters,
                  "wait_persisted": _wait_persisted}


@pytest.mark.parametrize("case", sorted(RECOVERY_CASES))
def test_recovery_matches_reference(case, tmp_path):
    out = {}
    for name, P in PACKAGES.items():
        rep, eng = RECOVERY_CASES[case](P, tmp_path / name)
        out[name] = (_report(rep), _records(eng), _underflow(eng),
                     dict(eng.scheduler.stats["placed_by_pool"]))
        eng.store.close()
    assert out["repro_torch"] == out["repro"]
    assert out["repro_torch"][2] == 0


def test_durability_off_has_no_journal():
    eng = PORT.acai.AcaiEngine(virtual=True, cluster_nodes=1)
    assert eng.journal is None and eng.store is None
    assert eng.registry.journal is None
    assert eng.scheduler.journal is None
    assert eng.launcher.journal is None
    assert eng.recovery is None


def test_threadpool_terminal_idempotent_across_recovery(tmp_path):
    def engine():
        return PORT.acai.AcaiEngine(runner="thread", durable=tmp_path / "s",
                                    workroot=str(tmp_path / "w"),
                                    cluster_nodes=1, quota_k=100)
    eng = engine()
    handles = [eng.submit(PORT.registry.JobSpec(
        name=f"t{i}", project="p", user="u", fn=PORT.jobs.echo_job,
        args={"msg": str(i)}, resources={"vcpu": 1.0, "mem_mb": 512.0}))
        for i in range(4)]
    for h in handles:
        assert h.wait(timeout=30.0).value == "FINISHED"
    eng.launcher.shutdown()
    eng.store.close()
    eng2 = engine()
    assert (eng2.recovery.terminal, eng2.recovery.requeued) == (4, 0)
    for h in handles:
        job = eng2.registry.get(h.job_id)
        assert job.outputs.get("echo") is not None
        eng2.bus.publish(TOPIC, {"job_id": h.job_id, "epoch": job.epoch,
                                 "status": "FINISHED"})
    assert eng2.scheduler.stats["completed"] == 0
    assert _underflow(eng2) == 0
    eng2.launcher.shutdown()
    eng2.store.close()


# ---------------------------------------------------------------------------
# the crash drill
# ---------------------------------------------------------------------------

DRILL_JOBS = 150


def test_drill_final_states_match_reference(tmp_path):
    finals = {}
    for name, P in PACKAGES.items():
        P.drill.run_fresh(tmp_path / name, n_jobs=DRILL_JOBS, seed=7)
        finals[name] = (tmp_path / name / "final.json").read_text()
    assert finals["repro_torch"] == finals["repro"]
    assert len(json.loads(finals["repro_torch"])) == DRILL_JOBS


def test_sigkill_drill_matches_golden(tmp_path):
    """``python -m repro_torch.core.engine.durable.drill`` killed with
    SIGKILL mid-fleet, then resumed over its state: the golden run's final
    states, no lost job, no duplicated terminal event."""
    golden = PORT.drill.run_fresh(tmp_path / "golden", n_jobs=DRILL_JOBS,
                                  seed=7)
    d = tmp_path / "crash"
    d.mkdir()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.core.engine.durable.drill",
         "--dir", str(d), "--n-jobs", str(DRILL_JOBS), "--seed", "7"],
        env=env)
    try:
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            assert proc.poll() is None, "the drill ended before the kill"
            try:
                if int((d / "progress").read_text() or 0) >= 40:
                    break
            except (FileNotFoundError, ValueError):
                pass
            time.sleep(0.01)
        else:
            raise AssertionError("the drill never reached 40 completions")
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.kill()
        proc.wait(timeout=10)
    out = PORT.drill.resume(d, DRILL_JOBS, seed=7)
    assert out["report"]["jobs_total"] == DRILL_JOBS
    assert out["final"] == golden
    assert out["duplicate_terminals"] == {}
    assert out["release_underflow"] == 0
    assert out["report"]["terminal"] >= 40
    assert out["report"]["requeued"] > 0


# ---------------------------------------------------------------------------
# the subprocess runner: the reference's six cases, on the port
# ---------------------------------------------------------------------------


def _sub_engine(P, tmp_path, **kw):
    return P.acai.AcaiEngine(runner="subprocess",
                             workroot=str(tmp_path / "w"),
                             durable=tmp_path / "state", quota_k=100, **kw)


def _sub_spec(P, name, fn, args=None):
    return P.registry.JobSpec(name=name, project="p", user="u", fn=fn,
                              args=args or {},
                              resources={"vcpu": 1.0, "mem_mb": 512.0})


def _sub_drain(eng, timeout=30.0):
    launcher = eng.scheduler.launcher
    while launcher.pending():
        launcher.step(timeout=timeout)


@pytest.fixture
def sub(tmp_path, spawned):
    eng = _sub_engine(PORT, tmp_path)
    yield eng
    eng.launcher.shutdown()
    eng.store.close()


def test_launch_result_outputs_and_log(sub):
    h = sub.submit(_sub_spec(PORT, "e", PORT.jobs.echo_job,
                             {"msg": "over the wire"}))
    _sub_drain(sub)
    job = sub.registry.get(h.job_id)
    assert job.state.value == "FINISHED"
    assert job.outputs["echo"] == "over the wire"
    assert "echo: over the wire" in job.outputs["log"]
    assert job.runtime is not None and job.runtime >= 0
    assert h.wait(timeout=1.0).value == "FINISHED"


def test_failure_carries_traceback(sub):
    h = sub.submit(_sub_spec(PORT, "f", PORT.jobs.fail_job, {"msg": "kaput"}))
    _sub_drain(sub)
    job = sub.registry.get(h.job_id)
    assert job.state.value == "FAILED"
    assert "kaput" in job.error


def test_unimportable_fn_fails_loudly(sub):
    h = sub.submit(_sub_spec(PORT, "lam", lambda w, j: {}))
    _sub_drain(sub)
    job = sub.registry.get(h.job_id)
    assert job.state.value == "FAILED"
    assert "importable" in job.error


def test_worker_survives_engine_death_and_readopts(tmp_path, spawned):
    marks = tmp_path / "marks.txt"
    eng1 = _sub_engine(PORT, tmp_path)
    h_slow = eng1.submit(_sub_spec(PORT, "slow", PORT.jobs.sleep_job,
                                   {"seconds": 3.0}))
    h_mark = eng1.submit(_sub_spec(PORT, "mark", PORT.jobs.append_once_job,
                                   {"path": str(marks), "seconds": 0.2}))
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if all(eng1.registry.get(h.job_id).state.value == "RUNNING"
               for h in (h_slow, h_mark)):
            break
        time.sleep(0.05)
    else:
        raise AssertionError("jobs never reached RUNNING in the worker")
    eng1.store.close()
    eng1.launcher._disconnect()
    del eng1
    time.sleep(1.0)
    eng2 = _sub_engine(PORT, tmp_path)
    rep = eng2.recovery
    assert rep.adopted >= 1 and rep.worker_results >= 1
    assert rep.requeued == 0
    assert eng2.registry.get(h_slow.job_id).epoch == 0
    _sub_drain(eng2)
    for h in (h_slow, h_mark):
        assert eng2.registry.get(h.job_id).state.value == "FINISHED"
    assert marks.read_text().splitlines() == [h_mark.job_id]
    eng2.launcher.shutdown()
    eng2.store.close()


def test_dead_worker_buffered_results_still_settle(tmp_path, spawned):
    marks = tmp_path / "marks.txt"
    eng1 = _sub_engine(PORT, tmp_path)
    h = eng1.submit(_sub_spec(PORT, "mark", PORT.jobs.append_once_job,
                              {"path": str(marks)}))
    _sub_drain(eng1)
    assert eng1.registry.get(h.job_id).state.value == "FINISHED"
    eng1.launcher.shutdown()
    eng1.store.close()
    time.sleep(0.3)
    journal = tmp_path / "state" / "journal.jsonl"
    keep = [ln for ln in journal.read_text().splitlines()
            if '"t": "submit"' in ln]
    journal.write_text("\n".join(keep) + "\n")
    eng2 = _sub_engine(PORT, tmp_path)
    assert eng2.recovery.worker_results == 1
    job = eng2.registry.get(h.job_id)
    assert job.state.value == "FINISHED"
    assert job.outputs["marked"] == h.job_id
    assert marks.read_text().splitlines() == [h.job_id]
    eng2.launcher.shutdown()
    eng2.store.close()


def test_duplicate_result_replay_applies_once(tmp_path, spawned):
    eng1 = _sub_engine(PORT, tmp_path)
    h = eng1.submit(_sub_spec(PORT, "e", PORT.jobs.echo_job))
    _sub_drain(eng1)
    eng1.store.close()
    eng1.launcher._disconnect()
    del eng1
    eng2 = _sub_engine(PORT, tmp_path)
    assert (eng2.recovery.terminal, eng2.recovery.worker_results) == (1, 0)
    assert eng2.registry.get(h.job_id).state.value == "FINISHED"
    assert eng2.launcher.pending() == 0
    eng2.launcher.shutdown()
    eng2.store.close()


def test_worker_marks_transient_by_class_name(tmp_path):
    w = PORT.worker._Worker(tmp_path / "w")
    for jid, fn in (("job-t", "_raise_transient"), ("job-f", "_raise_fatal")):
        w._run_job({"job": jid, "epoch": 0, "fn": f"{__name__}:{fn}",
                    "name": jid, "args": {},
                    "workdir": str(tmp_path / "jobs" / jid)})
    assert w._done["job-t"]["status"] == "FAILED"
    assert w._done["job-t"].get("transient") is True
    assert w._done["job-f"]["status"] == "FAILED"
    assert "transient" not in w._done["job-f"]


def _raise_transient(workdir, job):
    raise PORT.lifecycle.TransientJobError("flaky shard")


def _raise_fatal(workdir, job):
    raise RuntimeError("deterministic bug")


def test_worker_of_cpu_jobs_never_loads_torch(tmp_path, spawned):
    """The worker imports torch only once a job has: after an echo job its
    process has mapped no torch library."""
    eng = _sub_engine(PORT, tmp_path)
    h = eng.submit(_sub_spec(PORT, "e", PORT.jobs.echo_job))
    _sub_drain(eng)
    assert h.wait(timeout=1.0).value == "FINISHED"
    pid = eng.launcher._worker_pid()
    maps = Path(f"/proc/{pid}/maps").read_text()
    assert "libtorch" not in maps and "libc10" not in maps
    eng.launcher.shutdown()
    eng.store.close()


# ---------------------------------------------------------------------------
# the reference's subprocess-runner faults, fixed in the port (ROADMAP C)
# ---------------------------------------------------------------------------


def _platform_jobs(P, root, runner, specs):
    plat = P.acai.AcaiPlatform(root, runner=runner)
    admin = plat.create_project(plat.admin_token, "p")
    handles = [plat.submit_job(admin, P.registry.JobSpec(
        name=name, project="", user="", fn=fn, args=args))
        for name, fn, args in specs]
    states = [h.wait(timeout=60).value for h in handles]
    plat.engine(admin).launcher.shutdown()
    return plat.project(admin), handles, states


def test_overlapping_jobs_keep_their_own_logs(tmp_path, spawned):
    """Two jobs that overlap in one worker each print 20 tagged lines. The
    reference's worker (a process-wide ``redirect_stdout``) mixes them;
    the port's, like both packages' thread runners, keeps each job's own."""
    chatty = PORT.jobs.chatty_job       # torch-free: both workers import it
    specs = [(f"c{i}", chatty, {"tag": f"T{i}", "lines": 20,
                                "interval": 0.03}) for i in range(2)]
    logs = {}
    for name, P in PACKAGES.items():
        for runner in ("thread", "subprocess"):
            _, handles, states = _platform_jobs(
                P, tmp_path / name / runner, runner, specs)
            assert states == ["FINISHED", "FINISHED"]
            logs[name, runner] = [h.job.outputs["log"].splitlines()
                                  for h in handles]
    want = [[f"T{i} {k}" for k in range(20)] for i in range(2)]
    for key in (("repro", "thread"), ("repro_torch", "thread"),
                ("repro_torch", "subprocess")):
        assert logs[key] == want, key
    mixed = logs["repro", "subprocess"]
    assert mixed != want
    assert any(line.split()[0] != f"T{i}" for i, log in enumerate(mixed)
               for line in log)


def test_metrics_reach_metadata_behind_subprocess_runner(tmp_path, spawned):
    """Two jobs print ``[[acai:final_loss=...]]``: ``find_min`` names the
    smaller behind the thread runner in both packages and behind the
    port's subprocess runner; behind the reference's it finds nothing."""
    found = {}
    for name, P in PACKAGES.items():
        specs = [(f"m{i}", P.jobs.echo_job,
                  {"msg": f"[[acai:final_loss={loss}]]"})
                 for i, loss in enumerate((2.0, 1.0))]
        for runner in ("thread", "subprocess"):
            proj, handles, states = _platform_jobs(
                P, tmp_path / name / runner, runner, specs)
            assert states == ["FINISHED", "FINISHED"]
            found[name, runner] = (proj.metadata.find_min("final_loss",
                                                          kind="job"),
                                   handles[1].job_id)
    for key in (("repro", "thread"), ("repro_torch", "thread"),
                ("repro_torch", "subprocess")):
        best, want = found[key]
        assert best == want, key
    assert found["repro", "subprocess"][0] is None


# ---------------------------------------------------------------------------
# chaos: the same FaultPlan injects the same faults in both packages
# ---------------------------------------------------------------------------


def _chaos_engine(P, capacity, node_shape=None):
    registry = P.registry.JobRegistry()
    bus = P.events.EventBus()
    runner = P.launcher.VirtualRunner(registry, bus,
                                      pricing=P.pricing.CPU_PRICING)
    cl = P.cluster.Cluster(capacity, {"vcpu": 0.0}, node_shape=node_shape)
    sched = P.scheduler.Scheduler(registry, runner, bus, quota_k=100,
                                  cluster=cl)
    P.monitor.JobMonitor(bus, registry=registry)
    return registry, runner, sched


def _chaos_fleet(P, seed):
    registry, runner, sched = _chaos_engine(P, {"vcpu": 8.0})
    inj = P.faults.FaultInjector(P.faults.FaultPlan(
        seed=seed, transient_mtbf_s=7.0, straggler_mtbf_s=11.0),
        sched, runner)
    for i in range(6):
        sched.submit(registry.submit(P.registry.JobSpec(
            name=f"j{i}", project="p", user="u", duration=20.0,
            resources={"vcpu": 4.0},
            retry=P.registry.RetryPolicy(max_retries=3, backoff_base=1.0))))
    for _ in range(400):
        due = [t for t in (runner.next_completion(), sched.next_timer(),
                           inj.next_event()) if t is not None]
        if not due or runner.now > 500.0:
            break
        t = min(due)
        if runner.next_completion() == t:
            runner.step()
        else:
            runner.advance_to(t)
        inj.advance_to(runner.now)
        sched.tick()
    jobs = {j.job_id: (j.state.value, j.epoch, j.retries, j.failures,
                       j.runtime, j.cost) for j in registry.all_jobs()}
    return inj.events, jobs, dict(sched.stats)


def _node_kills(P, _):
    registry, runner, sched = _chaos_engine(P, {"vcpu": 8.0},
                                            node_shape={"vcpu": 4.0})
    inj = P.faults.FaultInjector(P.faults.FaultPlan(
        seed=1, node_mtbf_s=5.0, max_node_failures=1), sched, runner)
    sched.submit(registry.submit(P.registry.JobSpec(
        name="j", project="p", user="u", duration=500.0,
        resources={"vcpu": 4.0})))
    for _ in range(50):
        t = inj.next_event()
        if t is None or runner.now > 200.0:
            break
        runner.advance_to(t)
        inj.advance_to(runner.now)
        sched.tick()
    assert inj.node_failures == 1
    assert sched.pools["default"].node_health()["up"] == 1
    jobs = {j.job_id: (j.state.value, j.epoch) for j in registry.all_jobs()}
    return inj.events, jobs, dict(sched.stats)


@pytest.mark.parametrize("case", ["seed42", "seed7", "node_kills"])
def test_fault_injection_matches_reference(case):
    run = _node_kills if case == "node_kills" else _chaos_fleet
    arg = {"seed42": 42, "seed7": 7}.get(case)
    ref, port = (run(P, arg) for P in (REF, PORT))
    assert port == ref
    assert port[0]
    if case == "seed42":
        assert port[0] != _chaos_fleet(PORT, 7)[0]


# ---------------------------------------------------------------------------
# elastic pools
# ---------------------------------------------------------------------------


def _elastic_grow_shrink(P):
    registry, runner, sched = _chaos_engine(P, {"vcpu": 8.0})
    ctl = P.elastic.ElasticController(sched, {"default": P.elastic.PoolPolicy(
        node_shape={"vcpu": 8.0}, min_nodes=1, max_nodes=3, grow_at=0.9,
        shrink_at=0.3, cooldown_s=10.0)})
    jobs = [registry.submit(P.registry.JobSpec(
        name=f"j{i}", project="p", user="u", duration=100.0,
        resources={"vcpu": 8})) for i in range(2)]
    for j in jobs:
        sched.submit(j)
    steps = [ctl.step(now=0.0), ctl.step(now=1.0)]
    sched.run_to_completion()
    steps += [ctl.step(now=200.0), ctl.step(now=300.0)]
    return ([[dataclasses.asdict(d) for d in s] for s in steps],
            ctl.node_hours(until=3600.0),
            ctl.provisioned_cost(3600.0, {"default": 2.5}), ctl.nodes(
                "default"))


def _elastic_flat(P):
    registry, runner, sched = _chaos_engine(P, {"vcpu": 8.0})
    ctl = P.elastic.ElasticController(sched, {"default": P.elastic.PoolPolicy(
        node_shape={"vcpu": 8.0}, min_nodes=1, max_nodes=4)})
    return ([], ctl.node_hours(until=3600.0),
            ctl.provisioned_cost(3600.0, {"default": 2.5}),
            ctl.nodes("default"))


@pytest.mark.parametrize("fleet", ["grow_shrink", "flat"])
def test_elastic_controller_matches_reference(fleet):
    run = _elastic_grow_shrink if fleet == "grow_shrink" else _elastic_flat
    ref, port = run(REF), run(PORT)
    assert port == ref
    if fleet == "grow_shrink":
        assert [d["action"] for s in port[0] for d in s] == ["grow",
                                                             "shrink"]
        assert port[1]["default"] == pytest.approx(
            (2 * 200.0 + 1 * 3400.0) / 3600.0, rel=1e-6)
    else:
        assert port[2] == pytest.approx(2.5)


# ---------------------------------------------------------------------------
# dashboard, workflow replay and the fileset cache
# ---------------------------------------------------------------------------


def _etl_and_train(P, root):
    plat = P.acai.AcaiPlatform(root)
    admin = plat.create_project(plat.admin_token, "p")
    proj = plat.project(admin)
    proj.upload("/raw/data.txt", b"1 2 3 4", creator="a")
    proj.create_file_set("Raw", ["/raw/data.txt"], creator="a")

    def etl(workdir, job):
        nums = (workdir / "raw/data.txt").read_text().split()
        (workdir / "out/features.txt").write_text(
            " ".join(str(2 * int(n)) for n in nums))
        print("[[acai:rows=4]]")

    def train(workdir, job):
        feats = [int(x) for x in
                 (workdir / "Features/features.txt").read_text().split()]
        (workdir / "out/model.txt").write_text(str(sum(feats)))
        print(f"[[acai:training_loss={1.0 / max(sum(feats), 1)}]]")

    jobs = [plat.submit_job(admin, P.registry.JobSpec(
        name=name, project="", user="", fn=fn, input_fileset=src,
        output_fileset=dst, resources={"vcpu": 1, "mem_mb": 512}))
        for name, fn, src, dst in (("etl", etl, "Raw", "Features"),
                                   ("train", train, "Features", "Model"))]
    return plat, admin, proj, jobs


def _virtual_fleet(P):
    """A virtual engine with a pool, a failure and a preemption: its
    registry and scheduler for the dashboard's pages."""
    eng = P.acai.AcaiEngine(virtual=True, pricing=P.pricing.CPU_PRICING,
                            cluster_nodes=1, quota_k=100, preemption=True,
                            checkpoint_interval=10.0)
    for i, (dur, vcpu, user) in enumerate([(5.0, 2.0, "ann"),
                                           (30.0, 4.0, "bob"),
                                           (12.0, 4.0, "ann"),
                                           (7.0, 8.0, "bob"),
                                           (3.0, 1.0, "cy")]):
        eng.submit(P.registry.JobSpec(
            name=f"v{i}", project="p", user=user, duration=dur,
            resources={"vcpu": vcpu, "mem_mb": 512.0}))
    eng.launcher.step()
    run = _running(eng)
    eng.launcher.fail_running(run[0], "disk full")
    eng.scheduler.preempt(_running(eng)[0].job_id)
    _drain(eng)
    return eng


def test_dashboard_pages_match_reference(tmp_path):
    pages = {}
    for name, P in PACKAGES.items():
        eng = _virtual_fleet(P)
        meta_cls = importlib.import_module(
            f"{P.name}.core.datalake.metadata").MetadataStore
        meta = meta_cls(tmp_path / name / "meta")
        for j in eng.registry.all_jobs():
            meta.put(j.job_id, loss=len(j.spec.name) / 10, state="x")
        plat, admin, proj, _ = _etl_and_train(P, tmp_path / name / "plat")
        pages[name] = [
            P.dashboard.job_history(eng.registry, meta),
            P.dashboard.job_history(eng.registry, meta, status="FINISHED",
                                    sort_by="runtime", descending=True,
                                    page_size=2, page=1),
            P.dashboard.job_history(eng.registry, user="ann",
                                    sort_by="cost"),
            P.dashboard.scheduler_page(eng.scheduler, eng.monitor),
            P.dashboard.provenance_page(proj.provenance),
            P.dashboard.provenance_page(proj.provenance, "Model:1"),
            P.dashboard.provenance_page(proj.provenance, "Raw:1",
                                        direction="forward"),
        ]
    assert pages["repro_torch"] == pages["repro"]
    history, filtered, _, sched_page, whole, trace, fwd = pages["repro_torch"]
    assert "FAILED" in history and "loss=" in history
    assert "page 2 of" in filtered
    assert "| default | vcpu |" in sched_page and "preempted=1" in sched_page
    assert "Raw:1" in whole and "Model:1" in whole
    assert "Features:1" in trace and "Features:1" in fwd


def test_dashboard_surfaces_log_tags(tmp_path):
    plat, admin, proj, _ = _etl_and_train(PORT, tmp_path)
    eng = plat.engine(admin)
    page = PORT.dashboard.job_history(eng.registry, proj.metadata)
    assert "etl" in page and "train" in page and "rows=4" in page
    page = PORT.dashboard.job_history(eng.registry, proj.metadata,
                                      status="FINISHED", sort_by="runtime",
                                      descending=True, page_size=1)
    assert "page 1 of 2 (2 jobs)" in page


@pytest.mark.parametrize("override", [False, True])
def test_workflow_replay_matches_reference(override, tmp_path):
    out = {}
    for name, P in PACKAGES.items():
        plat, admin, proj, (j1, j2) = _etl_and_train(P, tmp_path / name)
        eng = plat.engine(admin)
        replayer = P.replay.WorkflowReplayer(proj, eng)
        plan = replayer.plan("Model:1")
        assert [s["job_id"] for s in plan] == [j1.job_id, j2.job_id]
        kw = {}
        if override:
            proj.upload("/raw/data.txt", b"10 20 30 40", creator="a")
            proj.create_file_set("Raw2", ["/raw/data.txt"], creator="a")
            kw["override_input"] = "Raw2:1"
        new_ids = replayer.replay("Model:1", **kw)
        out[name] = (plan, new_ids, proj.filesets.resolve("Model").version,
                     proj.storage.download("/Model/model.txt"),
                     sorted(proj.provenance.backward("Model:2")),
                     [eng.registry.get(i).spec.name for i in new_ids])
    assert out["repro_torch"] == out["repro"]
    plan, new_ids, version, model, back, names = out["repro_torch"]
    assert len(new_ids) == 2 and version == 2
    assert model == (b"200" if override else b"20")
    assert names == ["etl-replay", "train-replay"]
    if not override:
        assert any(src == "Features:2" for src, _ in back)


def test_fileset_cache_matches_reference(tmp_path):
    out = {}
    for name, P in PACKAGES.items():
        plat = P.acai.AcaiPlatform(tmp_path / name / "plat")
        admin = plat.create_project(plat.admin_token, "p")
        proj = plat.project(admin)
        proj.upload("/d/a.txt", b"x" * 100, creator="a")
        proj.create_file_set("S", ["/d/a.txt"], creator="a")
        cache = P.cache.FilesetCache(tmp_path / name / "cache",
                                     max_bytes=10_000)
        hits = [cache.materialize(proj.filesets, "S",
                                  tmp_path / name / f"j{i}")
                for i in range(2)]
        proj.upload("/d/a.txt", b"y" * 100, creator="a")
        proj.create_file_set("S", ["/d/a.txt"], creator="a")
        hits.append(cache.materialize(proj.filesets, "S",
                                      tmp_path / name / "j3"))
        out[name] = (hits, cache.stats,
                     (tmp_path / name / "j2/d/a.txt").exists(),
                     (tmp_path / name / "j3/d/a.txt").read_bytes())
    assert out["repro_torch"] == out["repro"]
    assert out["repro_torch"][0] == [False, True, False]
    assert out["repro_torch"][3] == b"y" * 100


def test_fileset_cache_eviction(tmp_path):
    plat = PORT.acai.AcaiPlatform(tmp_path / "plat")
    admin = plat.create_project(plat.admin_token, "p")
    proj = plat.project(admin)
    cache = PORT.cache.FilesetCache(tmp_path / "c", max_bytes=250)
    for i in range(3):
        proj.upload(f"/f{i}.bin", bytes(100), creator="a")
        proj.create_file_set(f"FS{i}", [f"/f{i}.bin"], creator="a")
        cache.materialize(proj.filesets, f"FS{i}", tmp_path / f"o{i}")
    assert cache.stats["bytes"] <= 250
    assert cache.stats["entries"] == 2


# ---------------------------------------------------------------------------
# the card's payloads refuse to run without a card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["probe_job", "cuda_sleep_job", "train_job",
                                  "serve_job"])
def test_card_jobs_refuse_without_a_card(name, tmp_path):
    """No fallback: a card job whose worker finds no CUDA device raises
    (and its job FAILs) instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    card_jobs = importlib.import_module("repro_torch.examples.card_jobs")
    job = types.SimpleNamespace(job_id="job-1", epoch=0,
                                spec=types.SimpleNamespace(args={}))
    with pytest.raises(RuntimeError, match="finds no CUDA device"):
        getattr(card_jobs, name)(tmp_path, job)


_RACE = """
import sys, threading
from repro_torch.configs import base
sys.setswitchinterval(1e-6)
n, errors = 32, []
barrier = threading.Barrier(n)
def look_up():
    barrier.wait()
    try:
        base.get_arch("olmo-1b")
    except KeyError as e:
        errors.append(str(e))
threads = [threading.Thread(target=look_up) for _ in range(n)]
for t in threads:
    t.start()
for t in threads:
    t.join(60)
print(len(errors), sum(t.is_alive() for t in threads))
"""


def test_config_lookups_from_threads_at_once_all_succeed():
    """Concurrent jobs in one worker look up their configs at once: each of
    32 threads, released together in a fresh interpreter, finds olmo-1b
    (ROADMAP C: a lookup that found the registry part-filled by another
    thread's imports raised KeyError)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for _ in range(3):
        proc = subprocess.run([sys.executable, "-c", _RACE], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.split() == ["0", "0"]
