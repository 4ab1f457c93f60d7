"""The port stands alone: importing every ``repro_torch`` module pulls in no
JAX, nothing of the ``repro`` package, no Triton and no networkx (the
machine with the card has none), needs no nvcc, and the entry points refuse
to run on a CUDA device that is not there."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.examples import hyperparam_sweep as HS  # noqa: E402
from repro_torch.examples import quickstart as Q  # noqa: E402
from repro_torch.examples import serve_batch as SB  # noqa: E402
from repro_torch.launch import serve as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.serve import decode as D  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "triton", "repro", "networkx")
             or m.startswith(("jax.", "jaxlib.", "triton.", "repro.",
                              "networkx.")))
print(len(names), "modules")
print("BAD", bad)
"""


def _env():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("JAX_PLATFORMS", None)
    return env


def test_importing_every_module_pulls_in_no_jax_repro_or_triton():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout
    assert int(proc.stdout.split()[0]) >= 94


def test_the_examples_import_no_jax_and_no_repro():
    """The serving and sweep examples alone (each copies what it needs of
    ``examples/``, which imports JAX)."""
    code = ("import sys\n"
            "import repro_torch.examples.serve_batch\n"
            "import repro_torch.examples.hyperparam_sweep\n"
            "print('BAD', sorted(m for m in sys.modules if m.split('.')[0]"
            " in ('jax', 'jaxlib', 'repro', 'examples')))\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout


def test_import_needs_no_nvcc(tmp_path):
    """Nothing is built at import: with no nvcc on PATH and CUDA_HOME
    pointing nowhere, every module still imports."""
    env = _env()
    env["PATH"] = str(Path(sys.executable).parent)
    env["CUDA_HOME"] = str(tmp_path / "no-cuda")
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sources_do_not_name_jax():
    for path in (SRC / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in ("jax", "repro",
                                                      "networkx"), \
                    f"{path}: {line}"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


CFG = get_arch("olmo-1b").reduced()
ENTRY_POINTS = {
    "init_params": lambda: M.init_params(CFG, 0),
    "make_prefill_step": lambda: D.make_prefill_step(CFG),
    "make_serve_step": lambda: D.make_serve_step(CFG, 8),
    "greedy_generate": lambda: D.greedy_generate(
        CFG, M.init_params(CFG, 0, device="cpu"), torch.zeros(1, 2).long(), 2),
    "launch.serve": lambda: L.serve(
        CFG, M.init_params(CFG, 0, device="cpu"), [[1, 2]], slots=1, buf=8,
        max_new=2),
    "make_train_step": lambda: TS.make_train_step(
        CFG, TS.TrainConfig(), OptimizerConfig()),
    "launch.train": lambda: LT.main(["--arch", CFG.name.removesuffix(
        "-smoke"), "--steps", "1"]),
    "examples.quickstart": lambda: Q.main(["--arch", CFG.name.removesuffix(
        "-smoke"), "--steps", "1"]),
    "examples.serve_batch": lambda: SB.main(["--arch", CFG.name.removesuffix(
        "-smoke"), "--max-new", "1"]),
    "examples.serve_batch.run": lambda: SB.run(CFG.name.removesuffix(
        "-smoke"), max_new=1),
    "examples.hyperparam_sweep": lambda: HS.main([]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_refuse_cuda_without_a_card(no_card, name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b", "olmoe-1b-7b"])
def test_recurrent_entry_points_refuse_cuda_without_a_card(no_card, arch,
                                                           name, monkeypatch):
    """The same entry points with an rwkv, a zamba and an MoE config."""
    monkeypatch.setitem(globals(), "CFG", get_arch(arch).reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_chip_smoke_fails_without_a_card(no_card):
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory with nothing else of the repo, the script
    cannot find the port and fails without printing a result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_media_fails_without_a_card(no_card):
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke_media.py")],
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_media_fails_without_chip_smoke(tmp_path):
    """The media script takes chip_smoke.py's helpers: alone in a
    directory it fails without printing a result."""
    shutil.copy(ROOT / "chip_smoke_media.py", tmp_path / "chip_smoke_media.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke_media.py"],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("script", ["chip_smoke.py", "chip_smoke_media.py"])
def test_smoke_scripts_do_not_name_jax(script):
    for line in (ROOT / script).read_text().splitlines():
        words = line.replace(",", " ").split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in ("jax", "repro",
                                                  "networkx"), line
