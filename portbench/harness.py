"""One run of one cell: set-up, the measured window, the traced readings,
the comparison with the reference, and the result line.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration file, its mix (``mixes/<traffic>.json``) and its
metrics; an end-to-end metric is computed here from the window by its name
(``ct_per_s``, ``latency_p<percentile>_ms``, ``setup_s``), a per-layer
metric by its reader ``metrics/<name>.py``.  ``kernels/<name>.json`` names
the hand-written kernels whose launches a trace must hold.
"""

from __future__ import annotations

import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import checks, tracing
from .inputs import Inputs
from .system import System
from .traffic import closed_loop, load_mix, run_program

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "seal_tpu"}
_LATENCY = re.compile(r"latency_p(\d+(?:\.\d+)?)_ms$")


class NoCard(RuntimeError):
    """The machine lacks the cards the cell asks for."""


class ForbiddenModules(RuntimeError):
    """The run loaded JAX or the JAX package."""


def cell_of(spec: dict, workload: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload} in BENCHMARK.json")


def config_of(spec: dict, root: Path, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name} in BENCHMARK.json")


def metrics_of(spec: dict, workload: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace 0) or per-layer metrics (trace 1)."""
    return [m for m in spec["per_layer" if trace else "end_to_end"] if workload in m.get("workloads", [workload])]


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "portbench_metric_" + re.sub(r"\W", "_", name)
    loaded = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(loaded)
    loaded.loader.exec_module(module)
    return module


def end_to_end(name: str, setup_s: float, window) -> Optional[float]:
    if name == "setup_s":
        return setup_s
    requests = window.requests
    if not requests:
        return None
    if name == "ct_per_s":
        return requests / (window.t_end - window.t_start)
    m = _LATENCY.match(name)
    if m:
        lat = np.repeat([(c.t_done - c.t_enqueue) * 1e3 for c in window.calls], [c.requests for c in window.calls])
        return float(np.percentile(lat, float(m.group(1))))
    raise KeyError(f"no end-to-end metric named {name}")


class Readings:
    """What the per-layer readers read: the window's calls, the profiled
    sub-window's device timeline and the host-and-device profile (each None
    where no complete trace was taken), one call's exact counts and named
    calls, the window's memory peak."""

    def __init__(self, config: dict, mix: dict, cuda: bool):
        self.config, self.mix, self.cuda = config, mix, cuda
        self.requests_per_call = int(mix["batch"])
        self.profile_calls = int(mix["profile_calls"])
        self.host_profile_calls = int(mix["in_flight"]) + 1
        self.window = None
        self.timeline: Optional[dict] = None
        self.host: Optional[dict] = None
        self.ops: Optional[dict] = None
        self.window_peak_bytes: Optional[int] = None


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _traced(readings: Readings, readers: dict, enqueue, mix: dict, cuda: bool, next_call: int) -> Dict[str, float]:
    """The per-layer readings of a traced run, taken after the window from
    further calls of the same loop: the profiled sub-window on the device
    alone, a host-and-device profile, and one call's exact counts."""
    nxt = [next_call]

    def more(count):
        rec = closed_loop(enqueue, mix["in_flight"], mix["batch"], cuda, calls=count, first_call=nxt[0],
                          labels=True)
        nxt[0] += count
        if rec.error is not None:
            raise rec.error

    def groups(kind):
        out = {}
        for reader in readers.values():
            out.update(getattr(reader, kind, {}))
        return out

    kernels = tracing.load_kernels(HERE / "kernels")
    if cuda:
        readings.timeline = tracing.device_timeline(lambda: more(readings.profile_calls), kernels)
        readings.host = tracing.host_profile(lambda: more(readings.host_profile_calls), groups("SPANS"))
    readings.ops = tracing.count_ops(lambda: enqueue(nxt[0]), kernels, groups("CALLS"), cuda)
    values = {}
    for name, reader in readers.items():
        v = reader.read(readings)
        if v is not None:
            values[name] = float(v)
    return values


def run(spec: dict, root: Path, workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", require_card: bool = True) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    cell = cell_of(spec, workload)
    cuda = device == "cuda"
    if require_card and (not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"])):
        raise NoCard(f"the cell needs {cell['chips']} CUDA card(s); torch sees "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    config = config_of(spec, root, cell["config"])
    mix = load_mix(HERE / "mixes" / f"{cell['traffic']}.json")
    metrics = metrics_of(spec, workload, trace)
    readers = {m["name"]: load_reader(m["name"]) for m in metrics} if trace else {}

    # ---- set-up: context, inputs, warm-up of the cell's own shapes ----------
    t_imported = time.perf_counter()
    system = System(config, mix, Inputs(config, seed, device), device)
    if cuda:
        torch.cuda.synchronize()
    t_built = time.perf_counter()

    def enqueue(i: int):
        return run_program(lambda name: getattr(system.evaluator, name), mix["program"], system.registers(i),
                           mix["output"])

    warm_calls = mix["in_flight"] + 1
    warm = closed_loop(enqueue, mix["in_flight"], mix["batch"], cuda, calls=warm_calls)
    if warm.error is not None:
        raise warm.error
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    print(f"portbench: set-up {setup_s:.2f} s: imports {t_imported - t_start:.2f} s, context and inputs "
          f"{t_built - t_imported:.2f} s, warm-up ({warm_calls} calls) {t_start + setup_s - t_built:.2f} s",
          file=sys.stderr)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # ---- the measured window --------------------------------------------
    sample = checks.Reservoir(mix["check_calls"], seed)
    window = closed_loop(enqueue, mix["in_flight"], mix["batch"], cuda, seconds=seconds, first_call=warm_calls,
                         on_done=lambda c: sample.offer({"call": c.index, **system.output(c.out)}))
    readings = Readings(config, mix, cuda)
    readings.window = window
    if cuda:
        readings.window_peak_bytes = torch.cuda.max_memory_allocated()
        memory_peak = max(memory_peak, readings.window_peak_bytes)
    print(f"portbench: window {window.t_end - window.t_start:.2f} s, {len(window.calls)} calls", file=sys.stderr)
    if window.error is not None:
        print(f"portbench: a call raised in the window: {window.error!r}", file=sys.stderr)

    values: Dict[str, float] = {}
    if trace and window.error is None:
        t_traced = time.perf_counter()
        values = _traced(readings, readers, enqueue, mix, cuda, warm_calls + len(window.calls))
        print(f"portbench: traced readings {time.perf_counter() - t_traced:.2f} s", file=sys.stderr)
    card = _card_line() if cuda else "cpu"
    print(f"portbench: {workload} seed {seed} on {card}", file=sys.stderr)

    # ---- free the program's state, then compare with the reference ------
    del system, enqueue
    checks.free_cuda()
    if window.error is None:
        t_ref = time.perf_counter()
        result_checks = checks.compare(config, mix, seed, sample.items, device)
        print(f"portbench: the reference checked {len(sample.items)} calls in {time.perf_counter() - t_ref:.2f} s",
              file=sys.stderr)
    else:
        result_checks = {"failed_calls": {"value": 1, "limit": 0, "rule": "at most"}}
    failed = window.requests_started - window.requests
    correct = checks.passed(result_checks) and failed == 0

    loaded = sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
    if loaded:
        raise ForbiddenModules(f"the run loaded {loaded}")

    if not trace:
        for m in metrics:
            v = end_to_end(m["name"], setup_s, window)
            if v is not None:
                values[m["name"]] = v
    units = {m["name"]: m["unit"] for m in metrics}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": int(cell["chips"]) if cuda else 0, "memory_peak_bytes": int(memory_peak), "card": card}
    result = {"correct": correct, "attempted": window.requests_started, "failed": failed,
              "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()}, "device": device_info}
    if readings.timeline is not None:
        device_info["busy_s"] = readings.timeline["busy_s"]
        device_info["window_s"] = readings.timeline["window_s"]
        result["breakdown"] = {"device_ops": readings.timeline["device_ops"],
                               "idle_gaps": readings.host["idle_gaps"] if readings.host else []}
    result["checks"] = result_checks
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="Run one cell of the seal_tpu_torch benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = HERE.parent
    spec = json.loads((root / "BENCHMARK.json").read_text())
    try:
        result = run(spec, root, args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    except NoCard as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    except ForbiddenModules as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 3
    for line in checks.lines(result["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0
