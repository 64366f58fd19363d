"""The comparison that decides ``correct`` fails what it must fail.

The control (``control.py``: the reference with floored instead of rounded
divisions) comes out not correct on three seeds for every cell.  And a run
of the harness, its look for a card skipped, comes out not correct when the
timed path is broken underneath in each way the cell can break: a step that
returns its input unchanged, half of a batch left out with the other half's
results standing in, and one answer's word altered where it is produced
(the cells run on one card, so no exchange between cards can be left out).
All at the test size, on the CPU.
"""

import time
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.control import control_checks
from seal_tpu_torch.parallel.batch import BatchEvaluator, CiphertextBatch

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["ckks32k-linear-batch8", "bfv8k-mulrelin-batch32"]
LAST_STEP = {"ckks32k-linear-batch8": "rescale_to_next", "bfv8k-mulrelin-batch32": "relinearize"}


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
    monkeypatch.setattr(BatchEvaluator, "relinearize", lambda self, ct, keys, *args: ct)
    result = _run(small_spec, workload)
    assert not result["correct"]
    assert result["checks"]["metadata_mismatches"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_half_a_batch_left_out_is_caught(small_spec, workload, monkeypatch):
    multiply = BatchEvaluator.multiply

    def half(self, b1, b2):
        h = b1.batch_size // 2
        cut = [CiphertextBatch(b.data[:h], b.parms_id, b.is_ntt_form, b.scale, b.correction_factor)
               for b in (b1, b2)]
        out = multiply(self, *cut)
        return CiphertextBatch(torch.cat([out.data, out.data]), out.parms_id, out.is_ntt_form, out.scale,
                               out.correction_factor)

    monkeypatch.setattr(BatchEvaluator, "multiply", half)
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
