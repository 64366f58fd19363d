"""A configuration and a cell added as data alone: new files and entries
appended to the spec, and no edit of the benchmark's code or tests.

The configuration brings its file, its test twin (found by ``twin_of``) and
its own plain reference (found by the file's ``reference`` key), all in a
copy of the places they would take in the repository (``tmp_path`` standing
for its root); the cell runs an existing mix.  The cell lists and output
steps that the other test files run are the spec's, and a reference that
carries a correction factor has it compared.  All at the test size, on the
CPU.
"""

import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from portbench import checks, harness
from portbench.control import control_checks, control_outputs
from portbench.system import System
from portbench.tests import conftest
from portbench.traffic import load_mix
from seal_tpu_torch.parallel.batch import CiphertextBatch

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
MIX = "linear-step-batch8"

# the default reference, logging each construction and each operation it is asked for
LOGGING_REFERENCE = '''
from pathlib import Path

from portbench.reference import program

LOG = Path(__file__).with_suffix(".log")


class Reference(program.Reference):
    def __init__(self, config, device, rounding=True):
        super().__init__(config, device, rounding)
        with LOG.open("a") as f:
            f.write(f"rounding {rounding}\\n")

    def op(self, name):
        with LOG.open("a") as f:
            f.write(name + "\\n")
        return super().op(name)
'''

# the default reference, exact even where the control asks it to floor, whose
# every result carries a correction factor of 5
FACTOR_REFERENCE = '''
from portbench.reference import program


class Reference(program.Reference):
    def __init__(self, config, device, rounding=True):
        super().__init__(config, device)

    def op(self, name):
        step = super().op(name)

        def with_factor(*args):
            out = step(*args)
            return program.Ct(out.data, out.ntt_form, out.scale, correction_factor=5)
        return with_factor
'''


def _configs(tmp_path: Path, monkeypatch, name: str, reference: str) -> Path:
    """With ``tmp_path`` as the repository's root, a configuration ``name``
    (the CKKS one at full size), its twin (the CKKS twin) in a copy of the
    twins' directory, and the reference module ``reference``, which both
    name; returns the twin's path."""
    module = Path("portbench/reference") / f"{name}.py"
    (tmp_path / module.parent).mkdir(parents=True)
    (tmp_path / module).write_text(reference)
    monkeypatch.setattr(checks, "ROOT", tmp_path)
    twins = tmp_path / "portbench" / "tests" / "configs"
    shutil.copytree(conftest.TWINS, twins)
    monkeypatch.setattr(conftest, "TWINS", twins)
    full = json.loads((HERE / "configs" / "ckks-n32768-tc128.json").read_text())
    twin = json.loads((twins / "ckks-n256-test.json").read_text())
    full.update(name=name, reference=str(module))
    twin.update(name=f"{name}-test", twin_of=name, reference=str(module))
    (tmp_path / f"{name}.json").write_text(json.dumps(full))
    (twins / f"{name}-test.json").write_text(json.dumps(twin))
    return twins / f"{name}-test.json"


def _extended(spec: dict, tmp_path: Path, name: str) -> dict:
    """``spec`` with the configuration ``name`` of ``tmp_path`` and a cell
    ``<name>.linear`` of it on an existing mix appended."""
    spec = json.loads(json.dumps(spec))
    spec["configs"].append({"name": name, "source": "test", "file": str(tmp_path / f"{name}.json"), "reduced": [],
                            "why": "a configuration added as files"})
    spec["workloads"].append({"name": f"{name}.linear", "config": name, "traffic": MIX, "chips": 1,
                              "why": "a cell added as an entry"})
    return spec


def test_an_added_configuration_runs_through_its_own_reference(spec, tmp_path, monkeypatch):
    _configs(tmp_path, monkeypatch, "ckks-added", LOGGING_REFERENCE)
    small = conftest.with_twins(_extended(spec, tmp_path, "ckks-added"))
    log = tmp_path / "portbench" / "reference" / "ckks-added.log"
    mix = load_mix(HERE / "mixes" / f"{MIX}.json")
    ops = [step[1] for step in mix["program"]]

    result = harness.run(small, ROOT, "ckks-added.linear", 2 ** 31 + 77, 4.0, False, time.perf_counter(),
                         device="cpu", require_card=False)
    assert result["correct"], result["checks"]
    compared = result["checks"]["compared_requests"]["value"]
    assert compared == mix["check_calls"] * mix["batch"]
    assert log.read_text().split("\n")[:-1] == ["rounding True"] + ops * compared

    log.unlink()
    control = control_checks(small, ROOT, "ckks-added.linear", 2 ** 32 + 78, "cpu")
    assert not checks.passed(control) and control["mismatched_words"]["value"] > 0, control
    # the control's outputs, then the comparison's reference judging them
    assert log.read_text().split("\n")[:-1] == ["rounding False"] + ops * compared + ["rounding True"] + ops * compared


def test_a_configuration_with_no_twin_names_the_file_to_add(spec, tmp_path, monkeypatch):
    twin = _configs(tmp_path, monkeypatch, "ckks-twinless", LOGGING_REFERENCE)
    twin.unlink()
    with pytest.raises(pytest.fail.Exception, match='portbench/tests/configs/ckks-twinless-test.json.*'
                                                    '"twin_of": "ckks-twinless"'):
        conftest.with_twins(_extended(spec, tmp_path, "ckks-twinless"))


def test_two_twins_of_one_configuration_are_refused(spec, tmp_path, monkeypatch):
    twin = _configs(tmp_path, monkeypatch, "ckks-twice", LOGGING_REFERENCE)
    shutil.copy(twin, twin.with_name("ckks-twice-again.json"))
    with pytest.raises(pytest.fail.Exception, match="are both twins of ckks-twice"):
        conftest.with_twins(_extended(spec, tmp_path, "ckks-twice"))


@pytest.mark.parametrize("path", ["{tmp}/portbench/reference/ckks-outside.py", "portbench/ckks-outside.py",
                                  "portbench/reference/../ckks-outside.py"])
def test_a_reference_outside_the_references_directory_is_refused(tmp_path, monkeypatch, path):
    monkeypatch.setattr(checks, "ROOT", tmp_path)
    for f in ("portbench/reference/ckks-outside.py", "portbench/ckks-outside.py"):
        (tmp_path / f).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / f).write_text(LOGGING_REFERENCE)
    with pytest.raises(ValueError, match="is not a path under portbench/reference/"):
        checks.reference_class({"name": "ckks-outside", "reference": path.format(tmp=tmp_path)})


def test_the_cells_under_test_are_the_benchmarks_workloads(spec):
    from portbench.tests import test_portbench_control, test_portbench_reference

    cells = [w["name"] for w in spec["workloads"]]
    assert test_portbench_reference.CELLS == test_portbench_control.CELLS == cells
    assert list(test_portbench_control.LAST_STEP) == cells
    assert {"ckks32k-linear-batch8": "rescale_to_next", "bfv8k-mulrelin-batch32": "relinearize"}.items() \
        <= test_portbench_control.LAST_STEP.items()


def test_a_differing_correction_factor_is_a_metadata_mismatch(tmp_path, monkeypatch):
    config = json.loads(_configs(tmp_path, monkeypatch, "ckks-factor", FACTOR_REFERENCE).read_text())
    mix = load_mix(HERE / "mixes" / f"{MIX}.json")
    sampled = control_outputs(config, mix, 2 ** 31 + 79, "cpu")
    assert all(item["correction_factor"] == 5 for item in sampled)
    agreed = checks.compare(config, mix, 2 ** 31 + 79, sampled, "cpu")
    assert checks.passed(agreed), agreed

    for item in sampled:
        item["correction_factor"] = 1
    differed = checks.compare(config, mix, 2 ** 31 + 79, sampled, "cpu")
    assert differed["mismatched_words"]["value"] == 0
    assert differed["metadata_mismatches"]["value"] == differed["compared_requests"]["value"] > 0


def test_the_program_reports_a_batchs_correction_factor():
    out = CiphertextBatch(torch.zeros(2, 2, 1, 4, dtype=torch.int64), None, True, 2.0, 7)
    assert System.output(out) == {"data": out.data, "ntt_form": True, "scale": 2.0, "correction_factor": 7}
