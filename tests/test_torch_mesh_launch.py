"""``python -m repro_torch.launch.train --mesh 2x2 --device cpu --backend
gloo`` trains reduced olmo-1b, olmoe-1b-7b, rwkv6-7b and zamba2-7b on 4
ranks it starts itself and ends with the reference's ``done:`` line; the meshes of the launcher
(``launch/mesh.py``) keep the reference's shapes."""
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.sharding import AbstractMesh  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("arch", ["olmo-1b", "olmoe-1b-7b", "rwkv6-7b",
                                  "zamba2-7b"])
def test_launch_train_on_a_2x2_mesh(tmp_path, arch):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--mesh", "2x2", "--device", "cpu", "--backend", "gloo", "--steps",
         "5", "--save-every", "2", "--workdir", str(tmp_path / "w")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:       # the launcher and the ranks it started
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    lines = out.strip().splitlines()
    assert lines[0] == "mesh 2x2: 4 ranks on gloo, device cpu"
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert [ln.split(":")[0] for ln in steps] == \
        [f"step {i}" for i in range(5)]      # rank 0 alone prints
    assert lines[-1] == "done: 5 steps, 3 ckpts, latest=5"


@pytest.mark.parametrize("multi_pod,shape", [
    (False, {"data": 16, "model": 16}),
    (True, {"pod": 2, "data": 16, "model": 16})])
def test_production_mesh_is_abstract_without_its_ranks(multi_pod, shape):
    mesh = LM.make_production_mesh(multi_pod=multi_pod)
    assert isinstance(mesh, AbstractMesh)
    assert mesh.shape == shape


@pytest.mark.parametrize("chips,shape", [
    (8, {"data": 1, "model": 8}), (64, {"data": 4, "model": 16}),
    (256, {"data": 16, "model": 16}),
    (512, {"pod": 2, "data": 16, "model": 16})])
def test_mesh_for_chips_keeps_the_reference_shapes(chips, shape):
    assert LM.mesh_for_chips(chips).shape == shape


@pytest.mark.parametrize("text,want", [
    ("2x2", ((2, 2), ("data", "model"))), ("1x4", ((1, 4), ("data", "model"))),
    ("4", ((4,), ("data",)))])
def test_parse_mesh(text, want):
    assert LM.parse_mesh(text) == want
