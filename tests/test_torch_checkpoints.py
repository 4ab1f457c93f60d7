"""The port's checkpoints and fault supervision (``repro_torch.train``'s
``checkpoints`` and ``fault``) against ``repro.train``'s on the CPU: the
reference's checkpoint round trip on tensors (bf16, the zero-size norm
sentinel, the int32 step), checkpoints of either package restoring bit for
bit in the other, restored tensors that own their memory, the supervisor's
report and hooks, its restart with no checkpoint, a supervised reduced
olmo-1b run with a failure that ends bit-equal to an uninterrupted one, and
the supervised ``launch.train`` driver."""
import dataclasses
import io
import json
import sys
import threading
import time
import types
import zipfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_arch  # noqa: E402
from repro.core.acai import AcaiProject as RefProject  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.launch import train as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import checkpoints as JC  # noqa: E402
from repro.train import fault as JF  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_arch as port_arch  # noqa: E402
from repro_torch.core.acai import AcaiProject  # noqa: E402
from repro_torch.core.engine import lifecycle  # noqa: E402
from repro_torch.data import pipeline as P  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.train import checkpoints as C  # noqa: E402
from repro_torch.train import fault as F  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import train_step as T  # noqa: E402

CPU = "cpu"
# tests/test_torch_train.py's multi-step tolerances: AdamW moves a weight
# by about lr * sign(g) a step, and fp32 noise between the frameworks can
# flip that sign where |g| is near zero, so a param may differ by 2 lr a
# step (all but 1e-3 of the entries within 1e-5); the moments, which carry
# no sign, at the gradients' tolerance
LR = 1e-3
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _bits(t):
    t = t.detach().cpu()
    return t.reshape(-1).view(torch.uint8) if t.numel() else \
        torch.empty(0, dtype=torch.uint8)


def _assert_bit_equal(got, want):
    """Nested dicts of tensors: same keys, dtypes, shapes, devices, bits."""
    got, want = convert.flatten(got), convert.flatten(want)
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        assert (g.dtype, g.shape, g.device) == (w.dtype, w.shape, w.device), \
            key
        assert torch.equal(_bits(g), _bits(w)), key


def _assert_np_bit_equal(got, want):
    got, want = convert.flatten(got), convert.flatten(want)
    assert list(got) == list(want)
    for key, w in want.items():
        g, w = np.asarray(got[key]), np.asarray(w)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), key
        assert g.tobytes() == w.tobytes(), key


def _leaves(tree):
    return list(convert.flatten(tree).values())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _small_state():
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "nested": {"b": torch.ones(4, dtype=torch.bfloat16) / 3},
              "norm": {"_np": torch.zeros(0)}}
    return params, O.init_opt_state(params)


def test_checkpoint_roundtrip(tmp_path):
    """``tests/test_train.py::test_checkpoint_roundtrip`` on tensors, with a
    bf16 leaf, OLMo's zero-size sentinel and the int32 step."""
    proj = AcaiProject("p", tmp_path)
    ckpt = C.CheckpointManager(proj, "run1")
    params, opt = _small_state()
    opt["step"] = torch.tensor(7, dtype=torch.int32)
    ref = ckpt.save(5, params, opt, extra={"loss": 1.5})
    assert ref.endswith(":1")
    state, step = ckpt.restore({"params": params, "opt": opt})
    assert step == 5
    _assert_bit_equal(state, {"params": params, "opt": opt})
    params2 = O.tree_map(lambda a: a + 1, params)
    ckpt.save(9, params2, opt)
    s2, st2 = ckpt.restore({"params": params, "opt": opt})
    assert st2 == 9
    _assert_bit_equal(s2["params"], params2)
    s1, st1 = ckpt.restore({"params": params, "opt": opt}, version=1)
    assert st1 == 5
    _assert_bit_equal(s1["params"], params)
    assert proj.metadata.get("run1-ckpt:2")["step"] == 9
    assert proj.metadata.get("run1-ckpt:1")["loss"] == 1.5
    assert ckpt.latest_step() == 9


def test_npz_holds_what_np_savez_writes(tmp_path):
    """The port writes each leaf's entry as ``np.savez`` does: the same
    names in the same order, stored, with the same bytes (bf16 widened)."""
    params, opt = _small_state()
    flat = convert.flatten({"params": params, "opt": opt})
    ours = zipfile.ZipFile(C.npz_bytes(flat))
    buf = io.BytesIO()
    np.savez(buf, **{k: (v.float() if v.dtype == torch.bfloat16 else v)
                     .numpy() for k, v in flat.items()})
    theirs = zipfile.ZipFile(buf)
    assert ours.namelist() == theirs.namelist() == [k + ".npy" for k in flat]
    for a, b in zip(ours.infolist(), theirs.infolist()):
        assert a.compress_type == b.compress_type == zipfile.ZIP_STORED
        assert ours.read(a) == theirs.read(b), a.filename


def _olmo(master_weights):
    """Reduced olmo-1b params and the optimizer state after one reference
    step (fp32 params, or bf16 params with fp32 masters), as numpy."""
    cfg = get_arch("olmo-1b").reduced()
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    if master_weights:
        jp = jax.tree.map(lambda p: p.astype(jnp.bfloat16), jp)
    tc = JT.TrainConfig(remat="none", master_weights=master_weights)
    pipe = JP.TokenPipeline(JP.DataConfig(vocab_size=32, seq_len=16,
                                          global_batch=2), cfg)
    jp, js, _ = jax.jit(JT.make_train_step(cfg, tc, JO.OptimizerConfig()))(
        jp, JT.make_opt_state(jp, tc),
        jax.tree.map(jnp.asarray, pipe.batch_at(0)))
    return jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)


def _port_state(params, opt):
    """The port's tensors of the same arrays (bf16 params through fp32)."""
    tp = convert.from_numpy(jax.tree.map(lambda a: a.astype(np.float32),
                                         params))
    if convert.flatten(params)["embed"].dtype != np.float32:
        tp = O.tree_map(lambda t: t.bfloat16(), tp)
    return {"params": tp, "opt": convert.opt_state_from_numpy(opt)}


@pytest.mark.parametrize("master_weights", [False, True])
@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_checkpoints_restore_across_packages(tmp_path, writer,
                                             master_weights):
    """A checkpoint of reduced olmo-1b params and optimizer state written
    by one package restores in the other bit for bit (the port against
    ``convert`` of the same arrays), and both write the same manifest."""
    params, opt = _olmo(master_weights)
    port = _port_state(params, opt)
    manifests = {}
    for pkg in ("repro", "repro_torch"):
        root = tmp_path / pkg
        if pkg == "repro":
            JC.CheckpointManager(RefProject("p", root), "run").save(
                1, jax.tree.map(jnp.asarray, params),
                jax.tree.map(jnp.asarray, opt), extra={"loss": 2.5})
        else:
            C.CheckpointManager(AcaiProject("p", root), "run").save(
                1, port["params"], port["opt"], extra={"loss": 2.5})
        manifests[pkg] = json.loads(
            AcaiProject("p", root).storage.download("/run-ckpt/manifest.json"))
    assert manifests["repro"] == manifests["repro_torch"]
    root = tmp_path / writer
    if writer == "repro":
        template = O.tree_map(torch.empty_like, port)
        state, step = C.CheckpointManager(AcaiProject("p", root),
                                          "run").restore(template)
        _assert_bit_equal(state, port)
    else:
        state, step = JC.CheckpointManager(RefProject("p", root),
                                           "run").restore(
            {"params": jax.tree.map(jnp.asarray, params),
             "opt": jax.tree.map(jnp.asarray, opt)})
        _assert_np_bit_equal(jax.tree.map(np.asarray, state),
                             {"params": params, "opt": opt})
    assert step == 1


def test_checkpoint_files_are_byte_identical_across_packages(tmp_path,
                                                             monkeypatch):
    """With the clock held still, the same save (a job edge from the
    registered data included) writes the same catalog, blobs, filesets,
    metadata and provenance in both packages."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    params, opt = _olmo(False)
    port = _port_state(params, opt)
    for pkg, project, mgr, state in (
            ("repro", RefProject, JC.CheckpointManager,
             jax.tree.map(jnp.asarray, {"params": params, "opt": opt})),
            ("repro_torch", AcaiProject, C.CheckpointManager, port)):
        proj = project("p", tmp_path / pkg)
        proj.upload("/datasets/d.json", b"{}")
        proj.create_file_set("d", ["/datasets/d.json"])
        mgr(proj, "run").save(3, state["params"], state["opt"],
                              extra={"loss": 2.5}, job_id="job-1",
                              input_fileset="d")
    files = {pkg: {str(p.relative_to(tmp_path / pkg)): p.read_bytes()
                   for p in sorted((tmp_path / pkg).rglob("*"))
                   if p.is_file()} for pkg in ("repro", "repro_torch")}
    assert list(files["repro_torch"]) == list(files["repro"])
    for name, data in files["repro"].items():
        assert files["repro_torch"][name] == data, name


def test_restored_tensors_own_their_memory(tmp_path):
    """Two restores and the live template share no memory: an in-place
    AdamW step on one restore (the port updates params and moments in
    place) leaves the other and the template as they were."""
    ckpt = C.CheckpointManager(AcaiProject("p", tmp_path), "run")
    params, opt = _small_state()
    params["nested"]["b"] = params["nested"]["b"].float()
    ckpt.save(1, params, opt)
    live = {"params": params, "opt": opt}
    a, _ = ckpt.restore(live)
    b, _ = ckpt.restore(live)
    ptrs = [t.data_ptr() for tree in (a, b, live) for t in _leaves(tree)
            if t.numel()]
    assert len(set(ptrs)) == len(ptrs)
    grads = O.tree_map(torch.ones_like, a["params"])
    O.adamw_update(O.OptimizerConfig(lr=0.1, warmup_steps=0), a["params"],
                   grads, a["opt"])
    assert int(a["opt"]["step"]) == 1
    assert not torch.equal(a["params"]["w"], params["w"])
    _assert_bit_equal(b, live)
    _assert_bit_equal(ckpt.restore(live)[0], live)


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"specs": {}}])
def test_restore_onto_a_mesh_raises(tmp_path, kw):
    """Restore onto a mesh runs (tests/test_torch_mesh.py); it raises when
    given a mesh without specs or specs without a mesh."""
    ckpt = C.CheckpointManager(AcaiProject("p", tmp_path), "run")
    params, opt = _small_state()
    ckpt.save(1, params, opt)
    with pytest.raises(ValueError, match="mesh and specs"):
        ckpt.restore({"params": params, "opt": opt}, **kw)


def test_restore_places_leaves_on_the_asked_device(tmp_path):
    """``device`` overrides the template's device; dtypes follow the
    template (a bf16 template leaf takes the saved fp32 values)."""
    ckpt = C.CheckpointManager(AcaiProject("p", tmp_path), "run")
    params = {"w": torch.linspace(-1, 1, 8)}
    ckpt.save(2, params)
    got, step = ckpt.restore({"params": {"w": torch.empty(8,
                                                          device="meta")}},
                             device="cpu")
    assert step == 2 and got["params"]["w"].device.type == "cpu"
    _assert_bit_equal(got, {"params": params})
    bf, _ = ckpt.restore({"params": {"w": torch.empty(8,
                                                      dtype=torch.bfloat16)}})
    assert torch.equal(bf["params"]["w"], params["w"].bfloat16())


# ---------------------------------------------------------------------------
# supervision
# ---------------------------------------------------------------------------


def _quadratic(pkg, root, fails, n_steps, save_every, clock=None):
    """The reference's supervisor test problem in one package: AdamW on
    w = 0 with unit gradients, a loss of sum(w²)."""
    if pkg == "repro":
        params = {"w": jnp.zeros(2)}
        opt, update, ones = JO.init_opt_state(params), JO.adamw_update, \
            jnp.ones
        proj, ckpt_cls, sup_mod = RefProject("p", root), \
            JC.CheckpointManager, JF
    else:
        params = {"w": torch.zeros(2)}
        opt, update, ones = O.init_opt_state(params), O.adamw_update, \
            torch.ones
        proj, ckpt_cls, sup_mod = AcaiProject("p", root), \
            C.CheckpointManager, F
    cfg = (JO if pkg == "repro" else O).OptimizerConfig(lr=0.1,
                                                        warmup_steps=0)

    def step_fn(params, opt, batch):
        p, o, _ = update(cfg, params, {"w": ones(2)}, opt)
        return p, o, {"loss": (p["w"] ** 2).sum()}

    fails = set(fails)

    def failure_hook(step):
        if step in fails:
            fails.discard(step)
            raise sup_mod.JobPreempted(f"node died at {step}")

    sup = sup_mod.TrainSupervisor(ckpt_cls(proj, "runF"),
                                  save_every=save_every, straggler_factor=3.0)
    kw = {} if clock is None else {"time_fn": lambda: next(clock)}
    return sup.run(step_fn, {"params": params, "opt": opt, "step": 0},
                   n_steps=n_steps, batch_fn=lambda s: {},
                   failure_hook=failure_hook, **kw)


def _clock():
    # time_fn is called twice per step; entry 9 is the *within-step* delta
    # of step 4 -> one straggler step
    return iter(np.concatenate([np.ones(9) * 0.01, [0.5],
                                np.ones(100) * 0.01]).cumsum())


def test_supervisor_restart_and_stragglers_match_reference(tmp_path):
    """``tests/test_train.py::test_supervisor_restart_and_stragglers`` in
    both packages, the same fake clock: the same report, and w within
    1e-6 after 22 AdamW steps."""
    runs = {pkg: _quadratic(pkg, tmp_path / pkg, {12}, 20, 5, _clock())
            for pkg in ("repro", "repro_torch")}
    (jstate, jrep), (tstate, trep) = runs["repro"], runs["repro_torch"]
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert tstate["step"] == jstate["step"] == 20
    assert trep.restarts == 1 and trep.steps_run == 22
    assert trep.checkpoints >= 4 and trep.straggler_steps == [4]
    np.testing.assert_allclose(tstate["params"]["w"].numpy(),
                               np.asarray(jstate["params"]["w"]), rtol=1e-6)
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) == 20


def _steady_clock():
    # every step takes 0.01 s, so no step is a straggler
    return iter(np.ones(200).cumsum() * 0.01)


def test_restart_without_a_checkpoint_keeps_the_trained_state(tmp_path):
    """The reference's quirk, kept: a failure before the first save
    restarts at step 0 from the live, already updated state (its AdamW
    counter goes on), not from the initial state. Both packages run on a
    steady fake clock: on the real clock a loaded machine can make one
    package's watchdog flag a straggler and not the other's."""
    runs = {pkg: _quadratic(pkg, tmp_path / pkg, {2}, 4, 5, _steady_clock())
            for pkg in ("repro", "repro_torch")}
    (jstate, jrep), (tstate, trep) = runs["repro"], runs["repro_torch"]
    assert jrep.straggler_steps == trep.straggler_steps == []
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert (trep.steps_run, trep.restarts, trep.checkpoints,
            trep.final_step) == (6, 1, 1, 4)
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) == 6
    np.testing.assert_allclose(tstate["params"]["w"].numpy(),
                               np.asarray(jstate["params"]["w"]), rtol=1e-6)
    clean, _ = _quadratic("repro_torch", tmp_path / "clean", (), 4, 5,
                          _steady_clock())
    assert not torch.equal(clean["params"]["w"], tstate["params"]["w"])


def _hook_outcomes(mod):
    """Each call of the hooks through a scripted job: None, or the raised
    ``JobPreempted``'s message and ``external`` flag."""
    out = []

    def call(hook, step):
        try:
            hook(step)
            out.append(None)
        except mod.JobPreempted as exc:
            out.append((str(exc), getattr(exc, "external", False)))

    job = types.SimpleNamespace(job_id="job-7", epoch=0, gang_pods=4,
                                preempt_flag=threading.Event())
    pre, res = mod.preemption_hook(job), mod.gang_resize_hook(job)
    call(pre, 0)
    call(res, 0)
    job.gang_pods = 2          # a shrink fires once
    call(res, 1)
    call(res, 2)
    job.gang_pods = 3          # growth does not
    call(res, 3)
    job.gang_pods = None
    call(res, 4)
    job.gang_pods = 1          # nor a width after an unknown one
    call(res, 5)
    job.preempt_flag.set()
    call(pre, 6)
    relaunched = types.SimpleNamespace(job_id="job-8", epoch=1,
                                       preempt_flag=None)
    pre2 = mod.preemption_hook(relaunched)
    call(pre2, 0)
    relaunched.epoch = 2       # a relaunch superseded this incarnation
    call(pre2, 1)
    return out


def test_hooks_behave_as_the_reference_does():
    got, want = _hook_outcomes(F), _hook_outcomes(JF)
    assert got == want
    assert [o[1] for o in got if o] == [False, True, True]
    assert F.JobPreempted is lifecycle.JobPreempted
    assert F.TransientJobError is lifecycle.TransientJobError
    assert not issubclass(F.JobPreempted, JF.JobPreempted)


def test_external_preemption_propagates(tmp_path):
    """A scheduler's preemption leaves the supervisor (the relaunch
    restores), with the checkpoint of step 2 saved."""
    job = types.SimpleNamespace(job_id="job-1", epoch=0,
                                preempt_flag=threading.Event())
    hook = F.preemption_hook(job)
    ckpt = C.CheckpointManager(AcaiProject("p", tmp_path), "run")
    params = {"w": torch.zeros(2)}

    def step_fn(params, opt, batch):
        if batch["step"] == 2:
            job.preempt_flag.set()
        return params, opt, {"loss": torch.tensor(0.0)}

    with pytest.raises(F.JobPreempted) as err:
        F.TrainSupervisor(ckpt, save_every=2).run(
            step_fn, {"params": params, "opt": O.init_opt_state(params),
                      "step": 0}, 6, lambda s: {"step": s}, hook)
    assert err.value.external and ckpt.latest_step() == 2


# -- reduced olmo-1b, supervised ---------------------------------------------


def _olmo_run(pkg, root, fail_at):
    """Reduced olmo-1b (fp32, remat none, AdamW lr 1e-3, weight decay 0.1)
    for 4 steps of 4x32 tokens under the supervisor, saving every 2 steps,
    with a non-external failure at ``fail_at`` (once). Returns the final
    state as numpy or tensors, the report and the loss of each step run."""
    cfg = get_arch("olmo-1b").reduced()
    params = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    tkw = dict(remat="none", compute_dtype="float32")
    okw = dict(lr=LR, warmup_steps=0, total_steps=100, weight_decay=0.1)
    dkw = dict(vocab_size=32, seq_len=32, global_batch=4, markov_temp=2.5)
    if pkg == "repro":
        step = jax.jit(JT.make_train_step(cfg, JT.TrainConfig(**tkw),
                                          JO.OptimizerConfig(**okw)))
        params = jax.tree.map(jnp.asarray, params)
        opt = JT.make_opt_state(params, JT.TrainConfig(**tkw))
        pipe = JP.TokenPipeline(JP.DataConfig(**dkw), cfg)
        ckpt = JC.CheckpointManager(RefProject("p", root), "olmo-1b-run")
        mod = JF

        def batch_fn(i):
            return jax.tree.map(jnp.asarray, pipe.batch_at(i))
    else:
        tcfg = port_arch("olmo-1b").reduced()
        step = T.make_train_step(tcfg, T.TrainConfig(**tkw),
                                 O.OptimizerConfig(**okw), device=CPU)
        params = convert.from_numpy(params)
        opt = T.make_opt_state(params, T.TrainConfig(**tkw))
        pipe = P.TokenPipeline(P.DataConfig(**dkw), tcfg)
        ckpt = C.CheckpointManager(AcaiProject("p", root), "olmo-1b-run")
        mod = F
        batch_fn = pipe.batch_at
    losses = []

    def step_fn(params, opt, batch):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        return params, opt, metrics

    pending = {fail_at}

    def failure_hook(s):
        if s in pending:
            pending.discard(s)
            raise mod.JobPreempted("injected failure")

    state, report = mod.TrainSupervisor(ckpt, save_every=2).run(
        step_fn, {"params": params, "opt": opt, "step": 0}, 4, batch_fn,
        failure_hook=failure_hook)
    return state, report, losses, ckpt


def test_supervised_olmo_with_a_failure_matches_an_uninterrupted_run(
        tmp_path):
    """A failure at step 3 with a save every 2 steps: the run restores
    step 2's checkpoint, runs steps 2 and 3 again and ends bit-equal to the
    port's uninterrupted run, step 2's loss repeated bit for bit; against
    the reference's supervised run the same report, losses within 1e-5
    relative and the final state within tests/test_torch_train.py's
    multi-step tolerances."""
    state, report, losses, ckpt = _olmo_run("repro_torch", tmp_path / "t", 3)
    clean, clean_report, clean_losses, _ = _olmo_run("repro_torch",
                                                     tmp_path / "c", None)
    assert (report.steps_run, report.restarts, report.checkpoints,
            report.final_step) == (5, 1, 2, 4)
    assert (clean_report.steps_run, clean_report.restarts) == (4, 0)
    assert losses[2] == losses[3] == clean_losses[2]
    assert losses[:3] + losses[4:] == clean_losses
    _assert_bit_equal({"params": state["params"], "opt": state["opt"]},
                      {"params": clean["params"], "opt": clean["opt"]})
    assert ckpt.latest_step() == 4
    metas = [ckpt.project.metadata.get(a) for a in
             ckpt.project.metadata.find(kind="checkpoint")]
    assert [m["step"] for m in metas] == [2, 4]

    jstate, jreport, jlosses, _ = _olmo_run("repro", tmp_path / "j", 3)
    assert dataclasses.asdict(report) == dataclasses.asdict(jreport)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = {k: v.numpy() for k, v in convert.flatten(state["params"]).items()}
    want = {k: np.asarray(v) for k, v in
            convert.flatten(jax.tree.map(np.asarray, jstate["params"])).items()}
    assert list(got) == list(want)
    for key, w in want.items():
        err = np.abs(got[key] - w)
        assert err.max(initial=0) <= 2 * LR * 4, key
        assert (err > 1e-5).mean() <= 1e-3 if w.size else True, key
    for key in ("mu", "nu"):
        g, w = convert.flatten(state["opt"][key]), convert.flatten(
            jax.tree.map(np.asarray, jstate["opt"][key]))
        for path in w:
            np.testing.assert_allclose(g[path].numpy(), w[path],
                                       err_msg=path, **GRAD_TOL)
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 4


def test_launch_train_supervised_prints_the_reference_summary(
        tmp_path, capsys, monkeypatch):
    """The supervised driver on the CPU ends with the reference driver's
    ``done:`` line for the same arguments, after its per-step loss lines,
    and leaves its checkpoints in ``--workdir``."""
    args = ["--steps", "4", "--save-every", "3"]
    LT.main(args + ["--device", "cpu", "--workdir", str(tmp_path / "t")])
    ours = capsys.readouterr().out.strip().splitlines()
    monkeypatch.setattr(sys, "argv", ["train"] + args +
                        ["--workdir", str(tmp_path / "j")])
    JL.main()
    theirs = capsys.readouterr().out.strip().splitlines()
    assert ours[-1] == theirs[-1] == "done: 4 steps, 2 ckpts, latest=4"
    assert [line.split(":")[0] for line in ours[:4]] == [
        f"step {i}" for i in range(4)]
    proj = AcaiProject("p", tmp_path / "t")
    assert proj.filesets.resolve("olmo-1b-run-ckpt").version == 2
    assert proj.filesets.exists("olmo-1b-data")
