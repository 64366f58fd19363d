"""Profiling and observability hooks.

Port of ``seal_tpu/profiling.py``.  The reference has no tracing framework;
its observability is the benchmark harness and wall-clock loops.  The port
keeps the JAX package's hooks, in PyTorch's idiom:

* :func:`trace`: a ``torch.profiler`` run over a block, exported as a
  Chrome trace (``chrome://tracing``, Perfetto);
* :func:`op_timer`: wall-clock seconds per call, with
  ``torch.cuda.synchronize()`` as the barrier for work on the card;
* :func:`device_time_us`, :func:`chained_device_time_us` and
  :func:`chained_slope_samples`: per-call device time on the card as the
  slope between K=lo and K=hi back-to-back (or chained) calls, each burst
  bracketed by CUDA events on one stream, so the fixed cost of a burst
  cancels;
* :func:`compile_stats`: the constants a context (and its evaluators) has
  built and cached, counted by name: the port's counterpart of the JAX
  package's jit cache.

The device timers time work on the card and raise for work elsewhere: a
CPU time is not a device time.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a card
    is present) and write ``<log_dir>/trace.json``, a Chrome trace.  Yields
    the profiler, whose ``key_averages()`` sum the operations by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (list, tuple)):
        for item in out:
            yield from _tensors(item)
    elif isinstance(out, dict):
        for item in out.values():
            yield from _tensors(item)
    elif hasattr(out, "data"):                     # a Ciphertext or a batch
        yield from _tensors(getattr(out, "data"))
    elif hasattr(out, "shards"):                   # a ShardedTensor
        yield from _tensors(out.shards)


def _on_card(out) -> bool:
    return any(t.is_cuda for t in _tensors(out))


def _barrier(out) -> None:
    """Wait for the work that produced ``out``: a device synchronize for
    tensors on the card; CPU tensors are ready when the call returns."""
    if _on_card(out):
        torch.cuda.synchronize()


def op_timer(fn: Callable, *args, iters: int = 10, warmup: int = 1) -> float:
    """Mean wall-clock seconds per call of ``fn(*args)`` over ``iters``
    calls after ``warmup``, the last call's work waited for."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _barrier(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _barrier(out)
    return (time.perf_counter() - t0) / iters


def _burst_ms(run: Callable[[int], object], k: int) -> float:
    """Device milliseconds of ``run(k)``, bracketed by CUDA events on the
    current stream."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run(k)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _require_card(out, what: str) -> None:
    if not _on_card(out):
        raise ValueError(f"{what} times work on the card; the call's output holds no CUDA tensor")


def device_time_us(fn: Callable, *args, lo: int = 3, hi: int = 13, repeats: int = 2) -> float:
    """Per-call device time of ``fn(*args)`` on the card, in microseconds:
    bursts of ``lo`` and ``hi`` back-to-back calls, each bracketed by CUDA
    events on one stream, and the slope ``(t_hi - t_lo) / (hi - lo)`` of
    the fastest of ``repeats`` bursts each, so a burst's fixed cost
    cancels.  Calls whose launches the host paces read as the host's
    time."""
    out = fn(*args)
    _require_card(out, "device_time_us")
    torch.cuda.synchronize()

    def run(k):
        for _ in range(k):
            fn(*args)

    run(lo)
    t_lo = min(_burst_ms(run, lo) for _ in range(repeats))
    t_hi = min(_burst_ms(run, hi) for _ in range(repeats))
    return max(0.0, (t_hi - t_lo) / (hi - lo)) * 1e3


def serialize_dependency(out_scalar, primary, alternate):
    """Returns ``primary`` unchanged.  The JAX package threads a
    compile-opaque dependency through here so that XLA cannot reorder or
    overlap chained ops; on the card the port's launches already run in
    order on one stream, so a chained step needs nothing.  The name stays
    so that code timing through it ports line for line."""
    return primary


def _chain(step: Callable, init) -> Callable[[int], object]:
    def run(k):
        carry = init
        for _ in range(k):
            carry = step(carry)
        return carry
    return run


def chained_device_time_us(step: Callable, init, lo: int = 4, hi: int = 20, repeats: int = 3) -> float:
    """Per-step device time in microseconds of ``step: carry -> carry``,
    chained K times from ``init``: the slope between K=lo and K=hi, each
    chain bracketed by CUDA events on one stream (fastest of ``repeats``).
    The span hi - lo grows (up to 4096) until the K-dependent signal is at
    least 20 ms."""
    run = _chain(step, init)
    _require_card(run(1), "chained_device_time_us")
    torch.cuda.synchronize()
    min_signal_ms = 20.0
    for _ in range(6):
        run(lo)
        t_lo = min(_burst_ms(run, lo) for _ in range(repeats))
        t_hi = min(_burst_ms(run, hi) for _ in range(repeats))
        signal = t_hi - t_lo
        if signal >= min_signal_ms or hi - lo >= 4096:
            break
        factor = max(2, int(min_signal_ms / max(signal, 1e-3)) + 1)
        hi = lo + min(4096, (hi - lo) * factor)
    return max(0.0, (t_hi - t_lo) / (hi - lo)) * 1e3


def chained_slope_samples(step: Callable, init, lo: int = 8, hi: int = 40, repeats: int = 3, samples: int = 5,
                          min_signal_s: float = 0.08):
    """``samples`` independent chained slopes (microseconds per step), as
    :func:`chained_device_time_us`: the span grows until the K-dependent
    signal reaches ``min_signal_s``, then stays fixed for every sample.
    Callers take the min and report (max - min) / median as the spread."""
    run = _chain(step, init)
    _require_card(run(1), "chained_slope_samples")
    torch.cuda.synchronize()
    min_signal_ms = min_signal_s * 1e3
    for _ in range(8):
        run(lo)
        t_lo = min(_burst_ms(run, lo) for _ in range(repeats))
        t_hi = min(_burst_ms(run, hi) for _ in range(repeats))
        signal = t_hi - t_lo
        if signal >= min_signal_ms or hi - lo >= 8192:
            break
        factor = max(2, int(min_signal_ms / max(signal, 1e-3)) + 1)
        hi = lo + min(8192, (hi - lo) * factor)
    out = []
    for _ in range(samples):
        t_lo = min(_burst_ms(run, lo) for _ in range(repeats))
        t_hi = min(_burst_ms(run, hi) for _ in range(repeats))
        out.append(max(0.0, (t_hi - t_lo) / (hi - lo)) * 1e3)
    return out


def compile_stats(context, *evaluators) -> Dict[str, int]:
    """The constants built and cached for ``context``, counted by name:
    per level, its table bundles (``tables q``, ``tables behz``, which
    counts a mesh rank's cut bundles too), the RNS tool's constant sets (``rescale``,
    ``mod_t``, ``behz``), its converters' (``convert``), the decode's
    composition constants (``compose``) and the Galois index tensors; and,
    for each evaluator given, its key-switch plans (``key_switch_plan``).
    Each entry is one build on one device."""
    stats: Dict[str, int] = {}

    def count(name: str) -> None:
        stats[name] = stats.get(name, 0) + 1

    seen = set()

    def first(obj) -> bool:
        """True the first time ``obj`` is met: levels may share a holder."""
        if obj is None or id(obj) in seen:
            return False
        seen.add(id(obj))
        return True

    for cd in context._context_data_map.values():
        for name, _device in cd._limb_tables:
            count("tables " + name.split("[")[0])
        tool = cd.rns_tool
        holders = [cd.base_q]
        if tool is not None:
            holders += [tool] + [v for v in vars(tool).values() if hasattr(v, "device_cache")]
        for holder in filter(first, holders):
            for key in holder.device_cache:
                count(key[0])
        if first(cd.galois_tool):
            for _ in cd.galois_tool._ntt_index:
                count("galois_ntt_index")
            for _ in cd.galois_tool._coeff_index:
                count("galois_coeff_index")
    for ev in evaluators:
        for parms_id, _device in ev._plans:
            if context.get_context_data(parms_id) is not None:
                count("key_switch_plan")
    return stats
