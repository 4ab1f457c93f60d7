"""The port's CLI (``python -m repro_torch.core.cli``) against the
reference's (``repro.core.cli``): the same commands over two roots print
the same output, a second invocation recovers the first one's jobs from
the project engine's journal, and the profiling feature spaces
(``core/provision/features.py`` over ``configs/shapes.py``) give the same
templates.

Two things differ by construction and are taken out before the outputs are
compared: each platform's tokens (``secrets.token_hex``), and the numbers
of the ``jobs``, ``cluster`` and ``find`` pages that a wall clock measures
(a job's runtime and bill, queue waits, the metadata's ``create_time``).
Each CLI runs its own package's payloads (``durable/jobs.py``), named by
``module:callable``."""
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.configs import base as ref_base  # noqa: E402
from repro.configs import shapes as ref_shapes  # noqa: E402
from repro.core import cli as ref_cli  # noqa: E402
from repro.core.provision import features as ref_features  # noqa: E402
from repro_torch.configs import base as port_base  # noqa: E402
from repro_torch.configs import shapes as port_shapes  # noqa: E402
from repro_torch.core import cli as port_cli  # noqa: E402
from repro_torch.core.provision import features as port_features  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CLIS = {"repro": ref_cli, "repro_torch": port_cli}
_NUM = re.compile(r"\d+\.\d+")
_WALL = ("create_time", "runtime", "cost")


class Session:
    """One package's CLI over its own root, each command a fresh
    ``main()``, as separate invocations of ``python -m ... cli`` are."""

    def __init__(self, pkg, root, capsys):
        self.pkg, self.cli, self.root = pkg, CLIS[pkg], str(root)
        self.capsys = capsys
        self.token = None

    def __call__(self, *argv):
        tok = ["--token", self.token] if self.token else []
        rc = self.cli.main(["--root", self.root, *tok, *argv])
        out, err = self.capsys.readouterr()
        return rc, out, err

    def fn(self, name):
        return f"{self.pkg}.core.engine.durable.jobs:{name}"


def _find_rows(out):
    rows = []
    for line in out.splitlines():
        aid, _, doc = line.partition(" ")
        rows.append((aid, {k: v for k, v in json.loads(doc).items()
                           if k not in _WALL}))
    return rows


def _script(s, data):
    """The commands, each one's (rc, stdout, stderr) normalised."""
    out = []
    rc, tok, _ = s("init", "demo")
    s.token = tok.strip()
    out.append(("init", rc, len(s.token)))
    steps = [
        ("upload", "/data/x.txt", str(data)),
        ("create-file-set", "D", "/data/x.txt"),
        ("ls",),
        ("submit", "echo", "--fn", s.fn("echo_job"), "--arg",
         "msg=[[acai:score=3]]", "--input-fileset", "D",
         "--output-fileset", "Out"),
        ("submit", "boom", "--fn", s.fn("fail_job"), "--arg",
         'msg="deliberate"'),
        ("submit", "child", "--fn", s.fn("echo_job"), "--after", "job-2"),
        ("submit", "orphan", "--fn", s.fn("echo_job"), "--after", "job-9"),
        ("submit", "pinned", "--fn", s.fn("echo_job"), "--pool", "gpu"),
        ("submit", "bad", "--fn", s.fn("echo_job"), "--resource", "chips"),
        ("submit", "late", "--fn", s.fn("echo_job"), "--no-wait",
         "--after", "job-1", "--resource", "vcpu=2", "--arg", "msg=7"),
        ("status", "job-1"), ("status", "job-2"), ("status", "job-404"),
        ("wait", "job-1", "--timeout", "5"),
        ("logs", "job-1"), ("logs", "job-3"), ("logs", "job-404"),
        ("jobs",), ("jobs", "--status", "FAILED", "--sort-by", "cost"),
        ("cluster",),
        ("find", "score>1"), ("find", "kind=fileset"),
        ("trace", "Out:1"), ("trace", "D:1", "--forward"), ("trace",),
    ]
    for argv in steps:
        rc, stdout, stderr = s(*argv)
        if argv[0] in ("jobs", "cluster"):
            stdout = _NUM.sub("#", stdout)
        if argv[0] == "find":
            stdout = _find_rows(stdout)
        if argv[0] == "status" and "error=" in stdout:
            stdout = stdout.split(" error=")[0] + " error=" + \
                stdout.rsplit(":", 1)[-1].strip()
        # the payloads' module names the package
        key = tuple(a.replace(f"{s.pkg}.", "PKG.") for a in argv)
        out.append((key, rc, stdout, stderr))
    return out


def test_cli_prints_what_the_reference_prints(tmp_path, capsys):
    data = tmp_path / "payload.txt"
    data.write_text("hello")
    runs = {pkg: _script(Session(pkg, tmp_path / pkg, capsys), data)
            for pkg in CLIS}
    ref, port = runs["repro"], runs["repro_torch"]
    for r, p in zip(ref, port):
        assert p == r, (p, r)
    assert len(port) == len(ref)
    got = {step[0]: step[1:] for step in port[1:]}
    echo = "PKG.core.engine.durable.jobs:echo_job"
    assert got["upload", "/data/x.txt", str(data)][1] == "/data/x.txt@1\n"
    assert got["submit", "pinned", "--fn", echo, "--pool", "gpu"][0] == 2
    assert got["status", "job-1"][1] == "FINISHED\n"
    assert got["status", "job-2"][1].startswith("FAILED")
    assert got["logs", "job-1"][1] == "echo: [[acai:score=3]]\n"
    assert "refusing submit: parent job-2 ended FAILED" in \
        got["submit", "child", "--fn", echo, "--after", "job-2"][2]
    assert [aid for aid, _ in got["find", "score>1"][1]] == ["job-1"]
    assert "D:1" in got["trace", "Out:1"][1]


def test_second_invocation_recovers_the_first_ones_jobs(tmp_path, capsys):
    """Each command is its own platform: the jobs of earlier invocations
    come back through the project engine's journal, terminal ones adopted
    as they were, with their outputs, and the first job's id is not
    reused."""
    s = Session("repro_torch", tmp_path / "cli", capsys)
    s.token = s("init", "demo")[1].strip()
    assert s("submit", "a", "--fn", s.fn("echo_job"), "--arg",
             "msg=one")[1].strip() == "job-1 FINISHED"
    plat = port_cli._load_platform(tmp_path / "cli")
    eng = plat.engine(s.token)
    assert (eng.recovery.terminal, eng.recovery.requeued) == (1, 0)
    job = eng.registry.get("job-1")
    assert (job.state.value, job.outputs["echo"]) == ("FINISHED", "one")
    eng.store.close()
    assert s("submit", "b", "--fn", s.fn("echo_job"))[1].strip() == \
        "job-2 FINISHED"
    assert s("status", "job-1")[1].strip() == "FINISHED"
    assert s("logs", "job-1")[1] == "echo: one\n"
    assert "| job-1 | a |" in s("jobs")[1]


def test_cli_root_defaults_to_the_temporary_directory(tmp_path):
    """Without ``--root`` the port's CLI keeps its platform under
    ``$TMPDIR/acai-cli``, not the reference's fixed ``/tmp/acai-cli``."""
    env = {"PATH": "/usr/bin:/bin", "TMPDIR": str(tmp_path),
           "PYTHONPATH": str(ROOT / "src"), "HOME": str(tmp_path)}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.cli", "init", "demo"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(proc.stdout.strip()) == 16
    assert (tmp_path / "acai-cli" / "tokens.json").exists()
    assert (tmp_path / "acai-cli" / "demo" / "state").is_dir()


def test_missing_token_exits_cleanly(tmp_path, capsys):
    for pkg in CLIS:
        rc, out, err = Session(pkg, tmp_path / pkg, capsys)("jobs")
        assert (rc, out, err) == (2, "", "--token required\n")


def test_feature_templates_match_reference():
    for name in port_base.list_archs():
        ref_cfg, port_cfg = ref_base.get_arch(name), port_base.get_arch(name)
        for shape in port_shapes.SHAPES:
            r = ref_features.template_for(ref_cfg, shape)
            p = port_features.template_for(port_cfg, shape)
            assert dataclasses.asdict(p) == dataclasses.asdict(r)
            assert p.grid() == r.grid()
    assert port_base.list_archs() == ref_base.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in port_shapes.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in ref_shapes.SHAPES.items()}
    cells = [[(a.name, s.name, ok, why) for a, s, ok, why in mod.cells(
        [base.get_arch(n) for n in base.list_archs()])]
        for mod, base in ((ref_shapes, ref_base), (port_shapes, port_base))]
    assert cells[1] == cells[0]
    assert any(not ok for _, _, ok, _ in cells[1])
