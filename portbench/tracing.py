"""What a traced run reads: the profiler's timelines over short steady
sub-windows of the closed loop, and exact counts of one call's operations.

* :func:`device_timeline`: ``torch.profiler`` on the device alone over a
  few calls; the device's busy time is the union of its operations'
  intervals, and each named kernel's device time is the sum of its
  operations'.  A trace is complete when it holds an operation for every
  kernel launch that the host's side of the trace recorded, and as many
  operations of each named kernel as its launch counter counted; an
  incomplete trace is taken again, and after a few tries none is used.
* :func:`host_profile`: a profile of host and device over a few calls,
  complete in the same sense, which names the device's idle time by the
  host's activity and gives the device time of the kernels launched inside
  named functions of the program (their spans).
* :func:`count_ops`: the aten calls of one call, counted by a
  ``TorchDispatchMode``, the launches of the hand-written kernels, read
  from their wrappers' counters, and the shapes of the arguments of named
  functions' calls.
"""

from __future__ import annotations

import contextlib
import heapq
import importlib
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

WINDOW_LABEL = "portbench.window"
SPAN_PREFIX = "portbench.span."


def load_kernels(directory: Path) -> Dict[str, dict]:
    """``kernels/<name>.json``: the device function names of a hand-written
    kernel and the wrapper whose ``launches`` attribute counts its launches."""
    return {p.stem: json.loads(p.read_text()) for p in sorted(Path(directory).glob("*.json"))}


def launches(kernels: Dict[str, dict]) -> Dict[str, int]:
    """The launch counters of the kernels whose wrapper module is loaded."""
    out = {}
    for name, spec in kernels.items():
        module = sys.modules.get(spec["counter"][0])
        if module is not None:
            out[name] = int(getattr(module, spec["counter"][1]).launches)
    return out


# ---- the profiled sub-window ------------------------------------------------

def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def _host_activities(cpu_events, times: List[float]) -> List[str]:
    """For each time (ascending), the innermost host operation running then
    (the one that started last), or 'host (python)'."""
    events = sorted(cpu_events, key=lambda e: e[1])
    heap: list = []
    out, j = [], 0
    for t in times:
        while j < len(events) and events[j][1] <= t:
            heapq.heappush(heap, (-events[j][1], events[j][2], events[j][0]))
            j += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else "host (python)")
    return out


def _events(prof):
    """(device operations, host operations) as (name, start s, end s); a
    host label mirrored on the device's timeline is no device work."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        item = (e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
        if e.device_type != DeviceType.CUDA:
            host.append(item)
        elif not getattr(e, "is_user_annotation", False):
            dev.append(item)
    return dev, host


def _top(d: Dict[str, float]) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]


def _launch_records(dev, host) -> Tuple[int, int]:
    """(kernel operations on the device, kernel launches on the host's side)
    of a trace; a launch the host recorded with no operation on the device
    is a dropped operation."""
    kernels = sum(1 for name, _, _ in dev if not name.startswith(("Memcpy", "Memset")))
    launched = sum(1 for name, _, _ in host if name.startswith("cudaLaunch"))
    return kernels, launched


def device_timeline(run_calls: Callable[[], None], kernels: Dict[str, dict], attempts: int = 4) -> Optional[dict]:
    """Busy seconds (the union of the device's operations), the window's
    seconds by the host clock, device seconds by operation name and by
    named kernel, from a profile of the device alone, which adds little to
    the host's time.  None where no attempt gave a complete trace."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(attempts):
        torch.cuda.synchronize()
        before = launches(kernels)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_calls()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        after = launches(kernels)
        dev, host = _events(prof)
        by_name: Dict[str, float] = defaultdict(float)
        for name, s, e in dev:
            by_name[name] += e - s
        named = {k: [(s, e) for name, s, e in dev if any(f in name for f in spec["functions"])]
                 for k, spec in kernels.items()}
        counted = {k: after[k] - before.get(k, 0) for k in after}
        records, launched = _launch_records(dev, host)
        missing = {k: (len(named.get(k, [])), c) for k, c in counted.items() if len(named.get(k, [])) != c}
        print(f"portbench: profiled sub-window {attempt + 1}: {records} kernel operations on the device, "
              f"{launched} launches on the host; named kernels (recorded, launched) "
              f"{ {k: (len(named.get(k, [])), c) for k, c in counted.items()} }", file=sys.stderr)
        if not missing and records >= launched and dev:
            return {"busy_s": sum(e - s for s, e in _merge([(s, e) for _, s, e in dev])), "window_s": window_s,
                    "device_ops": _top(by_name), "counted": counted,
                    "kernel_s": {k: sum(e - s for s, e in v) for k, v in named.items()}}
    print("portbench: no complete trace of the profiled sub-window; its readings are left out", file=sys.stderr)
    return None


@contextlib.contextmanager
def _patched(groups: Dict[str, List[List[str]]], wrap: Callable[[str, str, Callable], Callable]):
    """Inside the block, each of a group's functions (``[module, name]``)
    is replaced by ``wrap(group, name, function)``."""
    patched = []
    for group, fns in groups.items():
        for module_name, name in fns:
            module = importlib.import_module(module_name)
            original = getattr(module, name)
            setattr(module, name, wrap(group, name, original))
            patched.append((module, name, original))
    try:
        yield
    finally:
        for module, name, original in reversed(patched):
            setattr(module, name, original)


def spans(groups: Dict[str, List[List[str]]]):
    """Inside the block, each call to a group's functions runs under the
    profiler label ``portbench.span.<group>``; a call made from inside
    another call of the same group is part of it."""
    from torch.profiler import record_function

    depth = defaultdict(int)

    def wrap(group, _name, f):
        def wrapper(*args, **kwargs):
            if depth[group]:
                return f(*args, **kwargs)
            depth[group] += 1
            try:
                with record_function(SPAN_PREFIX + group):
                    return f(*args, **kwargs)
            finally:
                depth[group] -= 1
        return wrapper

    return _patched(groups, wrap)


def _device_time_s(event) -> float:
    """A host event's device seconds: its kernels' and its children's."""
    total = getattr(event, "device_time_total", None)
    return (event.cuda_time_total if total is None else total) / 1e6


def host_profile(run_calls: Callable[[], None], groups: Dict[str, List[List[str]]],
                 attempts: int = 4) -> Optional[dict]:
    """From a profile of host and device over ``run_calls()``: the device's
    idle seconds, summed by what the host was doing when each gap began
    (its innermost operation), and for each group of :func:`spans` the
    device seconds of the kernels launched inside its calls.  Recording the
    host's operations slows the host, so these gaps are longer than in an
    unprofiled run; the kernels' device times are not.  None where no
    attempt gave a complete trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(attempts):
        torch.cuda.synchronize()
        with spans(groups), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW_LABEL):
                run_calls()
                torch.cuda.synchronize()
        dev, host = _events(prof)
        records, launched = _launch_records(dev, host)
        window = [(s, e) for name, s, e in host if name == WINDOW_LABEL]
        print(f"portbench: host-and-device profile {attempt + 1}: {records} kernel operations on the device, "
              f"{launched} launches on the host", file=sys.stderr)
        if records < launched or not window or not dev:
            continue
        # the host's span (its kernels by correlation), not the device's mirror of it (gaps included)
        span_s = {g: sum(_device_time_s(e) for e in prof.events()
                         if e.name == SPAN_PREFIX + g and e.device_type == DeviceType.CPU) for g in groups}
        w0, w1 = window[0]
        merged = _merge([(max(s, w0), min(e, w1)) for _, s, e in dev if e > w0 and s < w1])
        gaps_at, edge = [], w0
        for s, e in merged + [(w1, w1)]:
            if s > edge:
                gaps_at.append((edge, s - edge))
            edge = max(edge, e)
        gaps: Dict[str, float] = defaultdict(float)
        for name, (_, length) in zip(_host_activities(host, [s for s, _ in gaps_at]), gaps_at):
            gaps[name] += length
        return {"idle_gaps": _top(gaps), "span_s": span_s}
    print("portbench: no complete host-and-device trace; its readings are left out", file=sys.stderr)
    return None


# ---- exact counts -----------------------------------------------------------

class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += 1
        return func(*args, **(kwargs or {}))


class Recorded:
    """One call to a named function: its arguments, each tensor replaced
    by a tensor of the same shape on the ``meta`` device."""

    def __init__(self, name: str, args: tuple, kwargs: dict):
        self.name, self.args, self.kwargs = name, args, kwargs


def _shape_only(x):
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    if type(x) in (list, tuple):
        return type(x)(_shape_only(v) for v in x)
    return x


def record_calls(groups: Dict[str, List[List[str]]], recorded: Dict[str, List[Recorded]]):
    """Inside the block, record the calls made to each group's functions in
    ``recorded[group]``, by their arguments' shapes."""
    def wrap(group, name, f):
        def wrapper(*args, **kwargs):
            recorded[group].append(Recorded(name, _shape_only(args), _shape_only(kwargs)))
            return f(*args, **kwargs)
        return wrapper

    return _patched(groups, wrap)


def count_ops(call: Callable[[], object], kernels: Dict[str, dict], groups: Dict[str, List[List[str]]],
              cuda: bool) -> dict:
    """The aten calls, the kernels' launches and the named functions' calls
    of one ``call()``."""
    if cuda:
        torch.cuda.synchronize()
    before = launches(kernels)
    mode = _CountOps()
    recorded: Dict[str, List[Recorded]] = {g: [] for g in groups}
    with record_calls(groups, recorded), mode:
        call()
    if cuda:
        torch.cuda.synchronize()
    after = launches(kernels)
    return {"aten": mode.count, "launches": {k: after[k] - before.get(k, 0) for k in after}, "calls": recorded}
