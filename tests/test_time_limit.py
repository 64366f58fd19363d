"""The per-test time limit of the repository's root ``conftest.py``, on an
inner pytest run.

The inner run has a copy of that conftest and, under its ``tests/``, three
tests: one that sleeps past its 1 s ``limit``, one after it that passes,
and one within its limit.  The sleeper fails with the limit's message, and
the run goes on and ends.
"""

import os
import pathlib
import subprocess
import sys
import time

import pytest

CONFTEST = pathlib.Path(__file__).resolve().parent.parent / "conftest.py"

INNER = '''
import time

import pytest


@pytest.mark.limit(1)
def test_sleeps_past_its_limit():
    time.sleep(30)


def test_runs_after_the_sleeper():
    assert True


@pytest.mark.limit(5)
def test_ends_within_its_limit():
    time.sleep(0.2)
'''


@pytest.mark.limit(60)
def test_a_test_past_its_limit_fails_and_the_run_goes_on(tmp_path):
    (tmp_path / "conftest.py").write_text(CONFTEST.read_text())
    (tmp_path / "pytest.ini").write_text("[pytest]\nmarkers =\n    limit(seconds): time limit\n    slow: slow\n")
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_inner.py").write_text(INNER)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}     # not one of this run's workers
    start = time.monotonic()
    run = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
                          "-p", "no:xdist", "tests"], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=50)
    out = run.stdout + run.stderr
    assert run.returncode == 1, out
    assert "test_sleeps_past_its_limit exceeded its time limit of 1 s in call" in out, out
    assert "1 failed, 2 passed" in out, out
    assert time.monotonic() - start < 30, out
