"""``BENCHMARK.json`` against the benchmark's contract, and the harness's
files found by name."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import end_to_end, metrics_of
from portbench.traffic import Call, LoopRecord, load_mix

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"[^\n\t]{1,200}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_benchmark_json_has_the_contract_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"] and SPEC["paths"] == ["portbench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    for section, keys in ENTRY_KEYS.items():
        for entry in SPEC[section]:
            assert set(entry) - {"workloads"} == keys, entry
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_text():
    for section in ENTRY_KEYS:
        names = [e["name"] for e in SPEC[section]]
        assert len(names) == len(set(names)), section
        assert all(NAME.match(n) for n in names), names
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for c in SPEC["configs"]:
        assert TEXT.match(c["source"]) and TEXT.match(c["why"]) and all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert TEXT.match(w["why"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for m in SPEC["per_layer"]:
        assert TEXT.match(m["layer"])


def test_every_cell_finds_its_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    pairs = set()
    for w in SPEC["workloads"]:
        cfg = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        assert cfg["name"] == w["config"] and cfg["reduced"] == configs[w["config"]]["reduced"]
        load_mix(HERE / "mixes" / f"{w['traffic']}.json")
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(SPEC["workloads"])
    assert {w["config"] for w in SPEC["workloads"]} == set(configs)
    for c in SPEC["configs"]:
        assert c["file"].startswith("portbench/")


def test_every_per_layer_metric_has_a_reader_and_lists_cells_that_report_what_it_moves():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells), (m["name"], cell)
    for cell in cells:
        assert any(m["name"] == "setup_s" for m in metrics_of(SPEC, cell, False))
        assert len(metrics_of(SPEC, cell, False)) >= 2 and metrics_of(SPEC, cell, True)


def test_every_end_to_end_metric_is_computed_by_name():
    window = LoopRecord(0.0, 2.0, [Call(i, 2, 0.1 * i, 0.1 * i, 0.1 * i + 0.5) for i in range(4)])
    for m in SPEC["end_to_end"]:
        assert end_to_end(m["name"], 1.0, window) > 0
    assert end_to_end("ct_per_s", 1.0, window) == 4.0
    assert end_to_end("latency_p50_ms", 1.0, window) == pytest.approx(500.0)


def test_the_budget_fits_24_cells():
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    four = sum(1 for w in SPEC["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_importing_the_benchmark_loads_no_jax():
    code = (
        "import sys, importlib, importlib.util, pathlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "root = pathlib.Path(sys.path[0]) / 'portbench'\n"
        "for p in sorted(root.rglob('*.py')):\n"
        "    rel = p.relative_to(root.parent)\n"
        "    if 'tests' in rel.parts or p.name == 'run.py':\n"
        "        continue\n"
        "    if rel.parts[1] == 'metrics':\n"
        "        spec = importlib.util.spec_from_file_location('m_' + p.stem.replace('.', '_'), p)\n"
        "        spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "    else:\n"
        "        importlib.import_module('.'.join(rel.with_suffix('').parts).replace('.__init__', ''))\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'seal_tpu'})\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_reference_imports_nothing_of_the_program():
    for p in (HERE / "reference").glob("*.py"):
        text = p.read_text()
        assert not re.search(r"^\s*(from|import)\s+(seal_tpu|seal_tpu_torch|jax)\b", text, re.M), p.name
        assert "portbench.system" not in text and "from ..system" not in text, p.name


def test_run_exits_without_a_card_or_without_the_program(tmp_path):
    # a directory with only BENCHMARK.json and portbench/: the program is missing
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    cell = SPEC["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    if not __import__("torch").cuda.is_available():
        out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", "1", "--seconds",
                              "1"], cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert out.returncode == 2 and not out.stdout.strip()


def test_a_trace_with_a_launch_and_no_operation_is_incomplete():
    from portbench.tracing import _launch_records
    host = [("cudaLaunchKernel", 0.0, 1.0), ("cudaLaunchKernelExC", 1.0, 2.0), ("aten::add", 0.0, 1.0)]
    dev = [("void add_kernel", 0.5, 0.6), ("Memcpy DtoD", 0.6, 0.7)]
    records, launched = _launch_records(dev, host)
    assert (records, launched) == (1, 2) and records < launched
    assert _launch_records(dev + [("ntt_forward_kernel", 1.5, 1.6)], host)[0] == launched


def test_recorded_calls_keep_shapes_and_no_data():
    import torch
    from portbench.tracing import count_ops
    from portbench.reference import arith

    out = count_ops(lambda: arith.addmod(torch.ones(3, 5, dtype=torch.int64), torch.ones(3, 5, dtype=torch.int64),
                                         torch.tensor(7)), {}, {"g": [["portbench.reference.arith", "addmod"]]},
                    False)
    (call,) = out["calls"]["g"]
    assert call.args[0].shape == (3, 5) and call.args[0].device.type == "meta" and out["aten"] > 0


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_client_holds_the_default_galois_keys_and_the_relinearization_key(cell):
    from portbench.traffic import key_elements, rotations
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    mix = load_mix(HERE / "mixes" / f"{w['traffic']}.json")
    config = json.loads((ROOT / next(c for c in SPEC["configs"] if c["name"] == w["config"])["file"]).read_text())
    n = config["poly_modulus_degree"]
    assert sorted(mix["client_keys"].values()) == ["galois_keys", "relin_keys"] and mix["clients"] > 1
    assert set(rotations(mix, n)) <= set(key_elements("galois_keys", n))
