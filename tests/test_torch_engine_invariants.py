"""The port's engine (``src/repro_torch/core/engine``, which the serving
and sweep examples run through) held to ``tools.acailint``'s invariants:
lock discipline, epoch guards, journal and codec coverage, reserve and
release pairing, lifecycle transition closure. acailint scopes itself to
``repro/core/engine`` by path; here its file and project checks run over
every file of the port's engine (``scoped=False``), with and without the
reference's baseline, and a violation seeded into a copy of the port's
engine shows that they visit the port's files."""
import shutil
from collections import Counter
from pathlib import Path

import pytest

from tools.acailint import DEFAULT_BASELINE, collect_files, run_files
from tools.acailint.core import load_baseline

ENGINE = Path(__file__).resolve().parents[1] / "src/repro_torch/core/engine"


def _violations(root, baseline=None):
    files = collect_files([root], scoped=False)
    assert len(files) >= 20, [f.path for f in files]
    return run_files(files, baseline)


@pytest.mark.parametrize("baseline", [False, True])
def test_the_ports_engine_lints_clean(baseline):
    got = _violations(ENGINE, load_baseline(DEFAULT_BASELINE)
                      if baseline else None)
    assert got == [], "\n".join(map(str, got))


def test_a_lock_taken_away_in_a_copy_is_reported(tmp_path):
    """``JobRegistry.get`` reads ``_jobs`` (guarded by ``_lock``) under its
    lock; the copy reads it bare, and ACAI101 reports it there."""
    copy = tmp_path / "engine"
    shutil.copytree(ENGINE, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = copy / "registry.py"
    text = path.read_text()
    guarded = ("    def get(self, job_id: str) -> Job:\n"
               "        with self._lock:\n"
               "            return self._jobs[job_id]\n")
    assert guarded in text
    path.write_text(text.replace(guarded, (
        "    def get(self, job_id: str) -> Job:\n"
        "        return self._jobs[job_id]\n")))
    got = _violations(copy)
    assert Counter(v.code for v in got) == {"ACAI101": 1}
    assert [Path(v.path).name for v in got] == ["registry.py"]
