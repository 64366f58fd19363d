"""The reader of ``modarith_ms_per_ct`` and kernel E's entry in
``kernels/``: the launches a trace must hold, and nothing to read from a
program without kernel E."""

import importlib
import json
from pathlib import Path

import pytest

from portbench.harness import Readings, load_reader
from portbench.tracing import load_kernels

HERE = Path(__file__).resolve().parents[1]
MIX = {"batch": 8, "profile_calls": 6, "in_flight": 2}


def _run(timeline):
    run = Readings({}, MIX, cuda=True)
    run.timeline = timeline
    return run


def _timeline(counted, kernel_s):
    return {"busy_s": 1.0, "window_s": 1.0, "device_ops": [], "counted": counted, "kernel_s": kernel_s}


def test_kernel_e_device_ms_per_request():
    read = load_reader("modarith_ms_per_ct").read
    run = _run(_timeline({"kernel_a": 48, "kernel_e": 120}, {"kernel_a": 0.001, "kernel_e": 0.012}))
    assert read(run) == pytest.approx(0.012 * 1e3 / (6 * 8))


@pytest.mark.parametrize("timeline", [None, _timeline({"kernel_a": 48}, {"kernel_a": 0.001, "kernel_e": 0.0}),
                                      _timeline({"kernel_e": 0}, {"kernel_e": 0.0})])
def test_nothing_to_read_without_kernel_e(timeline):
    """No trace, or a program whose wrapper is absent (the sub-window counts
    no launch of kernel E)."""
    assert load_reader("modarith_ms_per_ct").read(_run(timeline)) is None


def test_kernel_e_names_its_device_function_and_its_counter():
    kernels = load_kernels(HERE / "kernels")
    spec = kernels["kernel_e"]
    assert spec == json.loads((HERE / "kernels" / "kernel_e.json").read_text())
    module = importlib.import_module(spec["counter"][0])
    assert isinstance(getattr(module, spec["counter"][1]).launches, int)
    trace_name = "void (anonymous namespace)::modarith_kernel<5, true>((anonymous namespace)::Layout, " \
                 "unsigned long*, unsigned int)"
    for name, other in kernels.items():
        matches = any(f in trace_name for f in other["functions"])
        assert matches == (name == "kernel_e"), name
        assert not any(f in g for f in spec["functions"] for g in other["functions"] if name != "kernel_e")
