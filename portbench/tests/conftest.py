"""Shared set-up of the benchmark's tests: the repository root on the path,
the card fixture, and the benchmark's spec with each configuration swapped
for its small test twin under ``tests/configs``."""

import copy
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TEST_CONFIGS = {"ckks-n32768-tc128": "portbench/tests/configs/ckks-n256-test.json",
                "bfv-n8192-tc128": "portbench/tests/configs/bfv-n256-test.json"}


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def spec() -> dict:
    return load_spec()


@pytest.fixture
def small_spec() -> dict:
    """The benchmark's spec at the test size: every cell as it stands, each
    configuration replaced by a small one of the same scheme."""
    s = copy.deepcopy(load_spec())
    for c in s["configs"]:
        c["file"] = TEST_CONFIGS[c["name"]]
    return s


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: python -m pytest -m cuda portbench/tests")
    return "cuda"
