"""Shared set-up of the benchmark's tests: the repository root on the path,
the card fixture, and the benchmark's spec with each configuration swapped
for its small test twin: the file under ``tests/configs`` whose
``twin_of`` names it."""

import copy
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TWINS = Path(__file__).resolve().parent / "configs"


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def spec() -> dict:
    return load_spec()


def with_twins(spec: dict) -> dict:
    """``spec`` with each configuration's file replaced by its twin's: the
    file under ``TWINS`` whose ``twin_of`` names it, a small configuration
    of the same scheme and reference."""
    twins = {}
    for path in sorted(TWINS.glob("*.json")):
        twin = json.loads(path.read_text())
        if "twin_of" in twin:
            if twin["twin_of"] in twins:
                pytest.fail(f"{path} and {twins[twin['twin_of']][0]} are both twins of {twin['twin_of']}",
                            pytrace=False)
            twins[twin["twin_of"]] = (path, twin)
    s = copy.deepcopy(spec)
    for c in s["configs"]:
        if c["name"] not in twins:
            pytest.fail(f"configuration {c['name']} has no test twin: add portbench/tests/configs/"
                        f"{c['name']}-test.json, a small configuration of the same scheme with "
                        f"\"twin_of\": \"{c['name']}\"", pytrace=False)
        path, twin = twins[c["name"]]
        config = json.loads((ROOT / c["file"]).read_text())
        for key in ("scheme", "reference"):
            if twin.get(key) != config.get(key):
                pytest.fail(f"{path}: the twin's {key} is not {c['name']}'s", pytrace=False)
        c["file"] = str(path)
    return s


@pytest.fixture
def small_spec() -> dict:
    """The benchmark's spec at the test size: every cell as it stands, each
    configuration replaced by its twin."""
    return with_twins(load_spec())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: python -m pytest -m cuda portbench/tests")
    return "cuda"
