"""The paper's serving and sweep workflows as the port's examples, held
against the reference's (``examples/serve_batch.py`` and
``examples/hyperparam_sweep.py``, loaded from their paths):

- ``repro_torch.examples.serve_batch.run`` gives the reference's
  ``repro.serve.decode.greedy_generate`` tokens in fp32 (its serve step
  and decode state taken at fp32; the function fixes both to bf16) on
  weights converted by ``convert.py`` and the example's numpy-seeded
  prompts, for one reduced config of each family;
- ``hyperparam_sweep.fit`` gives the reference ``train_job``'s weights
  from the same data and initial weights;
- the port's sweep on the CPU gives the reference's stages, terminal
  states, DAG edges, broken pipeline and metadata keys, and a held count
  in the range that the ETL's race with the submission allows.
"""
import ast
import contextlib
import functools
import importlib.util
import io
import json
import sys
import tempfile
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_arch  # noqa: E402
from repro.core import acai as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import decode as JD  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.examples import hyperparam_sweep as HS  # noqa: E402
from repro_torch.examples import serve_batch as SB  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import jax_mesh_reference as JR  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# one reduced config of each family: dense, ssm, hybrid, moe, vlm, audio
FAMILIES = {"dense": "olmo-1b", "ssm": "rwkv6-7b", "hybrid": "zamba2-7b",
            "moe": "olmoe-1b-7b", "vlm": "llama-3.2-vision-11b",
            "audio": "musicgen-large"}
# fit against the reference's train_job: 100 fp32 steps from the same
# start, each package's own rounding; relative to each array's largest
# entry
FIT_TOL = 1e-5


def _reference(name):
    """The reference's example module ``examples/NAME.py``."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# serve_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_serve_batch_gives_the_references_greedy_tokens_fp32(family,
                                                             monkeypatch):
    """The example's flags at their defaults (batch 4, prompts of 8, 12 new
    tokens); the reference's zero-init leaves (RWKV's bonus and LoRA
    ends, the Mamba conv biases) and the VLM's tanh gates seeded
    (``jax_mesh_reference.seeded``), so that every path moves the
    tokens."""
    arch = FAMILIES[family]
    cfg = get_arch(arch).reduced()
    init = jax.jit(JM.init_params, static_argnums=0)
    params = JR.seeded(jax.tree.map(np.asarray, init(
        cfg, jax.random.PRNGKey(0))), np.random.default_rng(1))
    port_cfg = SB.config(arch)
    prompt, vision = SB.inputs(port_cfg, 4, 8)

    monkeypatch.setattr(JD, "make_serve_step", functools.partial(
        JD.make_serve_step, compute_dtype=jnp.float32))
    monkeypatch.setattr(JT, "init_decode_state", functools.partial(
        JT.init_decode_state, dtype=jnp.float32))
    want = JD.greedy_generate(
        cfg, jax.tree.map(jnp.asarray, params), jnp.asarray(prompt.numpy()),
        12, vision=None if vision is None else jnp.asarray(vision.numpy()))
    got = SB.run(arch, device="cpu", params=convert.from_numpy(params),
                 prompt=prompt, vision=vision, compute_dtype=torch.float32)
    assert got.shape == (4, 12, *((cfg.n_codebooks,) if cfg.n_codebooks
                                  else ()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_batch_inputs_from_the_numpy_seeds():
    cfg = SB.config("llama-3.2-vision-11b")
    a, b = SB.inputs(cfg, 2, 5), SB.inputs(cfg, 2, 5)
    assert a[0].shape == (2, 5)
    assert a[1].shape == (2, cfg.n_vision_tokens, cfg.vision_dim)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert SB.inputs(SB.config("olmo-1b"), 2, 5)[1] is None


def test_serve_batch_main_prints_the_references_lines(capsys):
    out = SB.main(["--device", "cpu", "--batch", "2", "--prompt-len", "3",
                   "--max-new", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "serving olmo-1b (reduced), batch=2"
    assert lines[1].startswith("prompt : [") and \
        lines[2].startswith("output : [")
    assert lines[3] == "ok — generated (2, 4) tokens"
    assert ast.literal_eval(lines[2].split(":", 1)[1].strip()) == \
        out[0].tolist()


# ---------------------------------------------------------------------------
# hyperparam_sweep
# ---------------------------------------------------------------------------

def _normalized():
    x, y = HS.raw_dump()
    x = (x - x.mean(0)) / (x.std(0) + 1e-6)
    return x.astype(np.float32), y


@pytest.mark.parametrize("hidden", HS.GRID["hidden"])
@pytest.mark.parametrize("lr", HS.GRID["lr"])
def test_fit_matches_the_references_train_job(tmp_path, hidden, lr,
                                              capsys):
    """The reference's ``train_job`` in a tmp workdir with a stub job, its
    weights from ``model.json``; the port's ``fit`` from the same data
    and the ``w0`` the reference draws (``jax.random.PRNGKey(seed)``,
    seed = hidden as the sweep sets it), passed as numpy."""
    ref = _reference("hyperparam_sweep")
    x, y = _normalized()
    (tmp_path / "TrainSet").mkdir()
    (tmp_path / "out").mkdir()
    (tmp_path / "TrainSet/train.json").write_text(
        json.dumps({"x": x.tolist(), "y": y.tolist()}))
    args = {"hidden": hidden, "lr": lr, "steps": HS.STEPS, "seed": hidden}
    ref.train_job(tmp_path, types.SimpleNamespace(
        spec=types.SimpleNamespace(args=args)))
    want = json.loads((tmp_path / "out/model.json").read_text())
    w0 = np.array(jax.random.normal(jax.random.PRNGKey(hidden),
                                    (x.shape[1], hidden)) * 0.1)
    # the reference reads x back from JSON: its float32 of the same text
    xs = torch.tensor(json.loads(
        (tmp_path / "TrainSet/train.json").read_text())["x"])
    w, v = HS.fit(xs, torch.from_numpy(y), torch.from_numpy(w0),
                  torch.zeros(hidden), lr, HS.STEPS)
    for got, ref_val in ((w, want["w"]), (v, want["v"])):
        ref_val = np.asarray(ref_val, np.float32)
        err = np.abs(got.numpy() - ref_val).max() / np.abs(ref_val).max()
        assert err <= FIT_TOL, (hidden, lr, err)
    assert "[[acai:accuracy=" in capsys.readouterr().out


class _Kept(JA.AcaiPlatform):
    """The reference's platform, keeping each instance and its projects'
    tokens, so that the test reads the lake its ``main`` wrote."""
    made = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.tokens = []
        _Kept.made.append(self)

    def create_project(self, admin_token, name):
        token = super().create_project(admin_token, name)
        self.tokens.append(token)
        return token


def _reference_sweep(tmp_path, monkeypatch):
    ref = _reference("hyperparam_sweep")
    _Kept.made = []
    monkeypatch.setattr(ref, "AcaiPlatform", _Kept)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref.main()
    lines = buf.getvalue().splitlines()

    def after(prefix):
        return next(line[len(prefix):] for line in lines
                    if line.startswith(prefix))
    stages, held = after("submitted ").split(" stages (")
    plat = _Kept.made[0]
    proj = plat.project(plat.tokens[0])
    best = json.loads(proj.storage.download("/SweepReport/best.json"))
    return {"stages": int(stages), "held": int(held.split()[0]),
            "states": ast.literal_eval(after("terminal states: ")),
            "edges": int(after("declared DAG edges recorded: ").split()[0]),
            "broken": ast.literal_eval(after("broken pipeline: ")),
            "best_keys": sorted(best)}


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        ref = _reference_sweep(tmp_path_factory.mktemp("ref_sweep"), mp)
    finally:
        mp.undo()
    port = HS.main(["--device", "cpu", "--workdir",
                    str(tmp_path_factory.mktemp("port_sweep"))])
    return ref, port


@pytest.mark.parametrize("key", ["stages", "states", "edges", "broken"])
def test_sweep_on_the_cpu_matches_the_reference(sweeps, key):
    ref, port = sweeps
    assert port[key] == ref[key]


def test_sweep_held_count_is_within_what_the_race_allows(sweeps):
    """The printed held count is the scheduler's when ``run()`` returns, in
    both packages, and races the ETL: the 9 stages after the ETL while it
    runs; fewer where the ETL finished during the submission (the sweep
    jobs submitted after its state turned FINISHED are not held, those
    before it until its terminal event is handled, the report while a
    sweep job runs). Either package may print any of 0 to 9."""
    ref, port = sweeps
    for got in (ref, port):
        assert 0 <= got["held"] <= got["stages"] - 1


def test_sweep_records_the_references_metadata_keys_only(sweeps):
    """The best job's metadata (what the report stage wrote) has the
    reference's keys: the device shows in the jobs' outputs only."""
    ref, port = sweeps
    assert sorted(port["best"]) == ref["best_keys"]
    assert port["devices"] == {f"train-h{h}-lr{lr}": "cpu"
                               for h in HS.GRID["hidden"]
                               for lr in HS.GRID["lr"]}


def test_sweep_values_of_the_reference_run(sweeps):
    ref, _ = sweeps
    assert ref["stages"] == 10 and ref["edges"] == 16
    assert ref["states"] == ["FINISHED"] * 10
    assert ref["broken"] == {"bad-etl": "FAILED",
                             "never-0": "UPSTREAM_FAILED",
                             "never-1": "UPSTREAM_FAILED"}
