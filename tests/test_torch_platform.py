"""The port's platform (``repro_torch.core.acai.AcaiPlatform``) running the
paper's workflow: upload -> fileset -> training jobs through the engine ->
checkpoint filesets with provenance -> a metadata query that finds the best
run. The twin of ``tests/test_system.py::test_full_acai_training_workflow``
trains the port's reduced olmo-1b on the CPU; with the clock held still the
two packages' workflows write the same lake, and each restores the other's
checkpoints on one root. Also: log isolation on the thread runner, what a
finished job keeps, the credential checks, the options not ported yet and
the port's quickstart."""
import gc
import importlib
import threading
import time
import weakref

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import acai as ref_acai  # noqa: E402
from repro.core.engine import registry as ref_registry  # noqa: E402
from repro.train import checkpoints as ref_checkpoints  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.core import acai as port_acai  # noqa: E402
from repro_torch.core.engine import registry as port_registry  # noqa: E402
from repro_torch.core.engine.lifecycle import JobState  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.examples import quickstart as Q  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import checkpoints as port_checkpoints  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig, leaves  # noqa: E402
from repro_torch.train.train_step import (TrainConfig,  # noqa: E402
                                          make_opt_state, make_train_step)

PACKAGES = {
    "repro": dict(acai=ref_acai, registry=ref_registry,
                  ckpt=ref_checkpoints, array=jnp.asarray,
                  host=np.asarray),
    "repro_torch": dict(acai=port_acai, registry=port_registry,
                        ckpt=port_checkpoints, array=torch.from_numpy,
                        host=lambda t: t.numpy()),
}
OTHER = {"repro": "repro_torch", "repro_torch": "repro"}
LRS = (3e-3, 1e-4)


def _platform(pkg, root, **kw):
    """A platform with project ``e2e``, the data description uploaded and
    fileset ``TrainData`` made from it, as the workflow test does."""
    plat = PACKAGES[pkg]["acai"].AcaiPlatform(root, **kw)
    admin = plat.create_project(plat.admin_token, "e2e")
    proj = plat.project(admin)
    proj.upload("/data/dataset.json", b'{"seed": 7}', creator="e2e")
    proj.create_file_set("TrainData", ["/data/dataset.json"], creator="e2e")
    return plat, admin, proj


def _submit_sweep(pkg, plat, admin, proj, train):
    """One job per learning rate: ``train(lr)`` gives (params, loss); the
    job saves the params at step 8 with the job's provenance and prints
    its final loss for the log parser."""
    m = PACKAGES[pkg]

    def train_job(workdir, job):
        lr = job.spec.args["lr"]
        params, loss = train(lr)
        m["ckpt"].CheckpointManager(proj, f"run-lr{lr}").save(
            8, params, extra={"final_loss": loss}, job_id=job.job_id,
            input_fileset="TrainData")
        print(f"[[acai:final_loss={loss}]]")

    return [plat.submit_job(admin, m["registry"].JobSpec(
        name=f"train-lr{lr}", project="", user="", fn=train_job,
        input_fileset="TrainData", args={"lr": lr},
        resources={"vcpu": 2, "mem_mb": 2048})) for lr in LRS]


def _train_port(lr):
    """8 steps of the port's reduced olmo-1b on the CPU, at the workflow
    test's settings."""
    cfg = get_arch("olmo-1b").reduced()
    params = M.init_params(cfg, 0, device="cpu")
    tcfg = TrainConfig()
    step = make_train_step(cfg, tcfg, OptimizerConfig(
        lr=lr, warmup_steps=2, weight_decay=0.0), device="cpu")
    opt = make_opt_state(params, tcfg)
    pipe = TokenPipeline(DataConfig(vocab_size=32, seq_len=16,
                                    global_batch=8, markov_temp=2.5), cfg)
    loss = None
    for i in range(8):
        params, opt, metrics = step(params, opt, pipe.batch_at(i))
        loss = float(metrics["loss"])
    return params, loss


def test_full_acai_training_workflow(tmp_path):
    """The twin of the reference's workflow test, with the port's model
    trained on the CPU inside the jobs."""
    plat, admin, proj = _platform("repro_torch", tmp_path)
    jobs = _submit_sweep("repro_torch", plat, admin, proj, _train_port)
    eng = plat.engine(admin)
    for j in jobs:
        assert eng.registry.get(j.job_id).state == JobState.FINISHED, \
            eng.registry.get(j.job_id).error

    # metadata: the higher-lr run should have learned more in 8 steps
    best = proj.metadata.find_min("final_loss", kind="job")
    assert eng.registry.get(best).spec.args["lr"] == pytest.approx(3e-3)
    for j in jobs:
        md = proj.metadata.get(j.job_id)
        assert md["state"] == "FINISHED" and md["runtime"] > 0
        assert md["cost"] > 0 and np.isfinite(md["final_loss"])
        assert "final_loss" in proj.storage.download(
            f"/.logs/{j.job_id}.log").decode()

    # provenance: checkpoint filesets trace back to the dataset
    for lr in LRS:
        back = proj.provenance.backward(f"run-lr{lr}-ckpt:1")
        assert any(src == "TrainData:1" for src, _ in back)
    # and the checkpoint is restorable
    cfg = get_arch("olmo-1b").reduced()
    template = M.init_params(cfg, 0, device="cpu")
    state, step_no = port_checkpoints.CheckpointManager(
        proj, "run-lr0.003").restore({"params": template})
    assert step_no == 8
    assert state["params"].keys() == template.keys()
    trained, _ = _train_port(3e-3)
    for got, want in zip(leaves(state["params"]), leaves(trained)):
        assert torch.equal(got, want)


def _seeded(pkg, lr):
    """Params made from a seed with numpy (the same bits in both
    packages) and a loss that depends on the learning rate alone."""
    rng = np.random.default_rng(int(lr * 1e5))
    arrays = {"embed": rng.standard_normal((16, 8), dtype=np.float32),
              "layers": {"w": rng.standard_normal((2, 8, 8),
                                                  dtype=np.float32),
                         "scale": np.ones((2, 8), np.float32)}}
    to = PACKAGES[pkg]["array"]
    params = {"embed": to(arrays["embed"]),
              "layers": {k: to(v) for k, v in arrays["layers"].items()}}
    return params, 1.0 + 100 * lr


def _lake_files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_workflow_writes_the_same_lake_as_the_reference(tmp_path,
                                                        monkeypatch):
    """With the clock held still (wall time and the runner's timer), the
    same workflow through each package's platform writes byte-identical
    lakes: catalog, blobs, filesets, job logs, metadata (the log parser's
    ``final_loss``, the runner's ``runtime``, ``cost`` and ``state``) and
    provenance."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    monkeypatch.setattr(time, "perf_counter", lambda: 50.0)
    records = {}
    for pkg in PACKAGES:
        plat, admin, proj = _platform(pkg, tmp_path / pkg)
        jobs = _submit_sweep(pkg, plat, admin, proj,
                             lambda lr, pkg=pkg: _seeded(pkg, lr))
        eng = plat.engine(admin)
        records[pkg] = [(j.job_id, eng.registry.get(j.job_id).state.value,
                         eng.registry.get(j.job_id).runtime,
                         eng.registry.get(j.job_id).cost,
                         proj.metadata.find_min("final_loss", kind="job"))
                        for j in jobs]
    assert records["repro_torch"] == records["repro"]
    assert [r[1] for r in records["repro"]] == ["FINISHED"] * 2
    files = {pkg: _lake_files(tmp_path / pkg / "e2e") for pkg in PACKAGES}
    assert list(files["repro_torch"]) == list(files["repro"])
    assert any(name.endswith("metadata.json") for name in files["repro"])
    assert any(name.endswith("provenance.json") for name in files["repro"])
    for name, data in files["repro"].items():
        assert files["repro_torch"][name] == data, name


@pytest.mark.parametrize("writer", sorted(PACKAGES))
def test_checkpoints_restore_across_packages_on_one_root(writer, tmp_path):
    """One package's workflow writes the lake; the other package's
    platform opens the same root, its job ids go on from the writer's,
    and its eval job restores the writer's best checkpoint bit for bit
    and saves one of its own, which the writer's package restores."""
    reader = OTHER[writer]
    plat, admin, proj = _platform(writer, tmp_path)
    _submit_sweep(writer, plat, admin, proj, lambda lr: _seeded(writer, lr))

    m = PACKAGES[reader]
    plat2 = m["acai"].AcaiPlatform(tmp_path)
    admin2 = plat2.create_project(plat2.admin_token, "e2e")
    proj2 = plat2.project(admin2)
    seen = {}

    def eval_job(workdir, job):
        best = proj2.metadata.find_min("final_loss", kind="job")
        run = f"run-lr{LRS[1]}"           # the smaller loss: 1 + 100 lr
        template, _ = _seeded(reader, LRS[1])
        state, step = m["ckpt"].CheckpointManager(proj2, run).restore(
            {"params": template})
        seen.update(best=best, step=step, params=state["params"])
        m["ckpt"].CheckpointManager(proj2, "eval").save(
            1, state["params"], job_id=job.job_id,
            input_fileset=f"{run}-ckpt")
        print(f"[[acai:restored_step={step}]]")

    h = plat2.submit_job(admin2, m["registry"].JobSpec(
        name="eval", project="", user="", fn=eval_job))
    assert h.status().value == "FINISHED", h.job.error
    assert h.job_id == "job-3"
    assert seen["best"] == "job-2" and seen["step"] == 8
    want, _ = _seeded("repro", LRS[1])
    host = m["host"]
    assert np.array_equal(host(seen["params"]["embed"]),
                          np.asarray(want["embed"]))
    assert np.array_equal(host(seen["params"]["layers"]["w"]),
                          np.asarray(want["layers"]["w"]))
    assert proj2.metadata.get("job-3")["restored_step"] == 8
    assert [src for src, _ in proj2.provenance.backward("eval-ckpt:1")] \
        == [f"run-lr{LRS[1]}-ckpt:1"]
    assert "TrainData:1" in proj2.provenance.ancestors("eval-ckpt:1")
    assert proj2.provenance.lineage_jobs("eval-ckpt:1") == ["job-2",
                                                            "job-3"]

    # the writer's package restores what the reader's job saved
    w = PACKAGES[writer]
    template, _ = _seeded(writer, LRS[1])
    state, step = w["ckpt"].CheckpointManager(
        w["acai"].AcaiProject("e2e", tmp_path / "e2e"), "eval").restore(
            {"params": template})
    assert step == 1
    assert np.array_equal(w["host"](state["params"]["layers"]["w"]),
                          np.asarray(want["layers"]["w"]))


def test_thread_runner_keeps_each_jobs_log(tmp_path):
    """Two port jobs run at once on the thread runner's workers, printing
    in turns: each job's log and parsed metadata hold its own lines
    only, and the test's own stdout none of them."""
    plat, admin, proj = _platform("repro_torch", tmp_path, runner="thread",
                                  max_workers=2)
    both = threading.Barrier(2, timeout=30)
    turn = threading.Condition()
    order = []

    def job_fn(workdir, job):
        me = job.spec.name
        both.wait()                      # both jobs are on workers now
        x = torch.zeros(4)
        for i in range(20):
            with turn:
                turn.wait_for(lambda: len(order) % 2 ==
                              (0 if me == "a" else 1), timeout=30)
                x += 1
                print(f"{me} line {i} on {threading.current_thread().name}")
                order.append(me)
                turn.notify_all()
        print(f"[[acai:who={me},total={int(x.sum())}]]")

    handles = [plat.submit_job(admin, port_registry.JobSpec(
        name=name, project="", user="", fn=job_fn)) for name in ("a", "b")]
    eng = plat.engine(admin)
    assert eng.wait_all(handles, timeout=60) == [JobState.FINISHED] * 2
    assert order == ["a", "b"] * 20
    threads = set()
    for h, me, other in zip(handles, ("a", "b"), ("b", "a")):
        log = h.logs()
        lines = log.splitlines()
        assert len(lines) == 21
        assert all(line.startswith(f"{me} line") for line in lines[:20])
        assert f"{other} line" not in log
        threads |= {line.split(" on ")[1] for line in lines[:20]}
        md = proj.metadata.get(h.job_id)
        assert md["who"] == me and md["total"] == 80
    assert len(threads) == 2
    assert all(t.startswith("acai-agent") for t in threads)
    eng.launcher.shutdown()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_thread_job_resolves_after_its_outputs(pkg, tmp_path, monkeypatch):
    """On the thread runner the registry shows FINISHED before the worker
    commits the job's outputs, log and metadata. The job's log upload is
    held at a gate here: the reference's handle resolves inside that
    window without the log (ROADMAP C); the port's waits for it."""
    plat, admin, proj = _platform(pkg, tmp_path, runner="thread",
                                  max_workers=1)
    gate = threading.Event()
    storage = type(proj.storage)
    upload = storage.upload

    def gated(self, path, *args, **kw):
        if path.startswith("/.logs/"):
            assert gate.wait(30)
        return upload(self, path, *args, **kw)

    monkeypatch.setattr(storage, "upload", gated)

    def job_fn(workdir, job):
        print("[[acai:answer=42]]")
        return {"answer": 42}

    h = plat.submit_job(admin, PACKAGES[pkg]["registry"].JobSpec(
        name="j", project="", user="", fn=job_fn))
    if pkg == "repro":
        try:
            deadline = time.monotonic() + 30
            while h.status().value != "FINISHED":   # the worker is at the
                assert time.monotonic() < deadline  # gate, after the flip
                time.sleep(0.01)
            assert h.result(timeout=30) == {"answer": 42}
            assert h.logs() == ""
        finally:
            gate.set()
    else:
        threading.Timer(0.2, gate.set).start()
        assert h.result(timeout=30) == {"answer": 42,
                                        "log": "[[acai:answer=42]]\n"}
        assert gate.is_set() and proj.metadata.get(h.job_id)["answer"] == 42
    plat.engine(admin).launcher.shutdown()


@pytest.mark.parametrize("runner", ["local", "thread"])
def test_finished_job_keeps_no_tensor(runner, tmp_path):
    """Nothing the engine keeps after a job (its record, outputs, handle,
    closure) holds the tensors the job made: on the card those would be
    the model's memory."""
    plat, admin, _ = _platform("repro_torch", tmp_path, runner=runner,
                               max_workers=1)
    refs = []

    def job_fn(workdir, job):
        params = {"w": torch.ones(64, 64)}
        refs.append(weakref.ref(params["w"]))
        print(f"[[acai:total={float(params['w'].sum())}]]")
        return {"total": float(params["w"].sum())}

    h = plat.submit_job(admin, port_registry.JobSpec(
        name="j", project="", user="", fn=job_fn))
    assert h.result(timeout=60) == {"total": 4096.0, "log": h.logs()}
    gc.collect()
    assert refs and refs[0]() is None
    if runner == "thread":
        plat.engine(admin).launcher.shutdown()


BAD_TOKEN_CALLS = {
    "authenticate": lambda plat, admin: plat.authenticate("bogus"),
    "project": lambda plat, admin: plat.project("bogus"),
    "engine": lambda plat, admin: plat.engine("bogus"),
    "submit_job": lambda plat, admin: plat.submit_job("bogus", (
        port_registry.JobSpec(name="j", project="", user=""))),
    "create_project": lambda plat, admin: plat.create_project(admin, "p2"),
    "create_user_by_member": lambda plat, admin: plat.create_user(
        plat.create_user(admin, "e2e", "alice"), "e2e", "eve"),
}


@pytest.mark.parametrize("call", sorted(BAD_TOKEN_CALLS))
def test_bad_token_raises_auth_error(call, tmp_path):
    plat, admin, _ = _platform("repro_torch", tmp_path)
    with pytest.raises(port_acai.AuthError):
        BAD_TOKEN_CALLS[call](plat, admin)
    assert len(plat.engine(admin).registry.all_jobs()) == 0


def test_durable_platform_recovers_a_project_engine(tmp_path):
    """``AcaiPlatform(durable=True)`` journals each project's engine under
    ``<root>/<project>/state``: a second platform over the same root
    recovers the first one's job into the project's engine, with its
    outputs, as the reference's does."""
    out = {}
    for pkg, acai, registry in (("repro", ref_acai, ref_registry),
                                ("repro_torch", port_acai, port_registry)):
        echo = importlib.import_module(
            f"{pkg}.core.engine.durable.jobs").echo_job
        plat = acai.AcaiPlatform(tmp_path / pkg, durable=True)
        admin = plat.create_project(plat.admin_token, "p")
        h = plat.submit_job(admin, registry.JobSpec(
            name="e", project="", user="", fn=echo, args={"msg": "kept"}))
        assert h.wait(timeout=30).value == "FINISHED"
        plat.engine(admin).store.close()
        plat2 = acai.AcaiPlatform(tmp_path / pkg, durable=True)
        eng2 = plat2.engine(plat2.create_project(plat2.admin_token, "p"))
        rep, job = eng2.recovery, eng2.registry.get(h.job_id)
        out[pkg] = ((rep.jobs_total, rep.terminal, rep.requeued),
                    job.state.value, job.epoch, job.outputs["echo"],
                    job.outputs["log"], job.spec.fn.__qualname__)
        eng2.store.close()
    assert out["repro_torch"] == out["repro"]
    assert out["repro_torch"][:4] == ((1, 1, 0), "FINISHED", 0, "kept")


def test_quickstart_runs_on_the_cpu(tmp_path, capsys):
    out = Q.main(["--device", "cpu", "--steps", "6", "--workdir",
                  str(tmp_path)])
    report = out["report"]
    assert (report.steps_run, report.checkpoints, report.restarts) == \
        (6, 1, 0)
    assert out["restored_step"] == 6
    n = sum(p.numel() for p in leaves(M.init_params(
        get_arch("olmo-1b").reduced(), 0, device="cpu")))
    assert out["eval"]["params"] == n
    text = capsys.readouterr().out
    assert f"eval job job-1: {n:,} params verified from checkpoint step 6" \
        in text
