"""The comparison that decides ``correct`` fails what it must fail.

The control (``control.py``: the reference with floored instead of rounded
divisions) comes out not correct on three seeds for every cell.  And a run
of the harness, its look for a card skipped, comes out not correct when the
timed path is broken underneath in each way the cell can break: a step that
returns its input unchanged, half of a batch left out with the other half's
results standing in, and one answer's word altered where it is produced
(the cells run on one card, so no exchange between cards can be left out).
Each fault breaks an operation that the cell's mix calls.  All at the test
size, on the CPU.
"""

import json
import time
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.control import control_checks
from portbench.traffic import load_mix
from seal_tpu_torch.parallel.batch import BatchEvaluator, CiphertextBatch

ROOT = Path(__file__).resolve().parents[2]
WORKLOADS = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
CELLS = [w["name"] for w in WORKLOADS]


MIXES = {w["name"]: load_mix(ROOT / "portbench" / "mixes" / f"{w['traffic']}.json") for w in WORKLOADS}
OPS = {cell: [name for _, name, *_ in mix["program"]] for cell, mix in MIXES.items()}
# the operation of the mix's last step that writes its output
LAST_STEP = {cell: [name for out, name, *_ in mix["program"] if out == mix["output"]][-1]
             for cell, mix in MIXES.items()}
# the step made to return its input: the relinearization, whose output has a
# polynomial fewer, where the mix has one, else the output step
RETURNS_INPUT = {cell: "relinearize" if "relinearize" in ops else LAST_STEP[cell] for cell, ops in OPS.items()}
# the step made to leave out half of its batch: the multiplication where the
# mix has one, else its first step
HALVED = {cell: "multiply" if "multiply" in ops else ops[0] for cell, ops in OPS.items()}


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(small_spec, workload):
    for seed in (11, 2 ** 31 + 12, 2 ** 32 + 13):
        checks = control_checks(small_spec, ROOT, workload, seed, "cpu")
        assert checks["mismatched_words"]["value"] > checks["mismatched_words"]["limit"], (seed, checks)


def _run(spec, workload):
    return harness.run(spec, ROOT, workload, 2 ** 31 + 5, 4.0, False, time.perf_counter(), device="cpu",
                       require_card=False)


@pytest.mark.parametrize("workload", CELLS)
def test_a_step_that_returns_its_input_is_caught(small_spec, workload, monkeypatch):
    monkeypatch.setattr(BatchEvaluator, RETURNS_INPUT[workload], lambda self, ct, *args: ct)
    result = _run(small_spec, workload)
    assert not result["correct"]
    found = ["metadata_mismatches"] if RETURNS_INPUT[workload] == "relinearize" else \
        ["metadata_mismatches", "mismatched_words"]
    assert sum(result["checks"][name]["value"] for name in found) > 0


@pytest.mark.parametrize("workload", CELLS)
def test_half_a_batch_left_out_is_caught(small_spec, workload, monkeypatch):
    step = getattr(BatchEvaluator, HALVED[workload])

    def half(self, *args):
        cut = [CiphertextBatch(a.data[:a.batch_size // 2], a.parms_id, a.is_ntt_form, a.scale, a.correction_factor)
               if isinstance(a, CiphertextBatch) else a for a in args]
        out = step(self, *cut)
        return CiphertextBatch(torch.cat([out.data, out.data]), out.parms_id, out.is_ntt_form, out.scale,
                               out.correction_factor)

    monkeypatch.setattr(BatchEvaluator, HALVED[workload], half)
    result = _run(small_spec, workload)
    assert not result["correct"]
    assert result["checks"]["mismatched_words"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_one_altered_word_is_caught(small_spec, workload, monkeypatch):
    step = getattr(BatchEvaluator, LAST_STEP[workload])

    def altered(self, *args):
        out = step(self, *args)
        out.data = out.data.clone()
        out.data.view(-1)[7] ^= 1
        return out

    monkeypatch.setattr(BatchEvaluator, LAST_STEP[workload], altered)
    result = _run(small_spec, workload)
    assert not result["correct"]
    assert result["checks"]["mismatched_words"]["value"] >= 1
