"""The one generator of traffic: it reads a mix file and drives a closed loop.

A mix (``mixes/<name>.json``) states:

* ``batch``: the requests one client sends in one call, served at once by
  ``BatchEvaluator``; ``in_flight``: calls enqueued before the loop waits
  on the oldest one's completion (1: wait for each);
* ``clients``: the clients whose keys and requests stay on the card; call
  i serves client i mod ``clients``;
* ``requests``: each client's per-request ciphertext inputs;
  ``client_keys``: each client's key sets, ``relin_keys`` (one key) or
  ``galois_keys`` (Microsoft SEAL's default set, ``create_galois_keys()``);
  ``shared``: what every client's calls share (``plaintext``);
* ``program``: the operations of one call, each ``[out, op, args...]``: an
  evaluator method applied to registers (names) and integers;
  ``output``: the register that is the call's result;
* ``check_calls``: completed calls, drawn from the seed, whose every output
  word the reference recomputes; ``profile_calls``: calls in the traced
  run's profiled sub-window.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch
from torch.profiler import record_function

from .reference.program import galois_elt_from_step, galois_elts_all

ENQUEUE_LABEL = "portbench.enqueue"
WAIT_LABEL = "portbench.wait"

MIX_KEYS = {"batch", "in_flight", "clients", "requests", "client_keys", "shared", "program", "output", "check_calls",
            "profile_calls"}
KEY_KINDS = ("relin_keys", "galois_keys")


def load_mix(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    if set(mix) != MIX_KEYS:
        raise ValueError(f"{path}: a mix has exactly the keys {sorted(MIX_KEYS)}")
    for key in ("batch", "in_flight", "clients", "check_calls", "profile_calls"):
        if not isinstance(mix[key], int) or mix[key] < 1:
            raise ValueError(f"{path}: {key} must be a positive integer")
    if not set(mix["client_keys"].values()) <= set(KEY_KINDS) or set(mix["shared"].values()) - {"plaintext"}:
        raise ValueError(f"{path}: client_keys are {KEY_KINDS}; shared inputs are plaintexts")
    return mix


def key_elements(kind: str, n: int) -> List[Optional[int]]:
    """The keys of a client's set of ``kind``, in their order in the set:
    the Galois element of each Galois key, None for the relinearization key."""
    return galois_elts_all(n) if kind == "galois_keys" else [None]


def rotations(mix: dict, n: int) -> List[int]:
    """The Galois elements of the mix's rotations at degree n, each of which
    a client's default Galois keys hold."""
    elts = sorted({galois_elt_from_step(int(step[3]), n) for step in mix["program"]
                   if step[1] in ("rotate_vector", "rotate_rows")})
    if not set(elts) <= set(galois_elts_all(n)):
        raise ValueError("a rotation of the mix has no key in the default Galois key set")
    return elts


def run_program(op: Callable[[str], Callable], program: List[list], registers: Dict[str, object], output: str):
    """Apply each step ``[out, name, args...]`` with ``op(name)``; strings
    among the args name registers."""
    regs = dict(registers)
    for out, name, *args in program:
        regs[out] = op(name)(*[regs[a] if isinstance(a, str) else a for a in args])
    return regs[output]


@dataclass
class Call:
    index: int
    requests: int
    t_enqueue: float
    t_enqueued: float = 0.0
    t_done: float = 0.0
    out: object = None
    event: object = None


@dataclass
class LoopRecord:
    t_start: float
    t_end: float = 0.0
    calls: List[Call] = field(default_factory=list)
    requests_started: int = 0
    error: Optional[BaseException] = None

    @property
    def requests(self) -> int:
        """Requests completed."""
        return sum(c.requests for c in self.calls)


def closed_loop(enqueue: Callable[[int], object], in_flight: int, requests_per_call: int, cuda: bool,
                seconds: Optional[float] = None, calls: Optional[int] = None, first_call: int = 0,
                on_done: Optional[Callable[[Call], None]] = None, labels: bool = False) -> LoopRecord:
    """Enqueue calls back to back, keeping ``in_flight`` of them queued:
    call i + 1 is enqueued before the loop waits on call i's completion
    event.  Runs for ``seconds`` (no new call after that) or for ``calls``
    calls, then waits for every queued call.  A call's latency runs from
    the moment its enqueue starts to the moment the host sees its event
    complete.  ``on_done`` sees each completed call's output, which the
    record then drops.  ``labels`` marks the enqueues and waits for a
    profiler's trace."""
    span = record_function if labels else (lambda _: contextlib.nullcontext())
    rec = LoopRecord(time.perf_counter())
    pending: deque = deque()

    def complete(c: Call):
        if c.event is not None:
            with span(WAIT_LABEL):
                c.event.synchronize()
        c.t_done = time.perf_counter()
        rec.calls.append(c)
        if on_done is not None:
            on_done(c)
        c.out = c.event = None

    i = first_call
    try:
        while True:
            now = time.perf_counter()
            if (seconds is not None and now - rec.t_start >= seconds) or (calls is not None and i - first_call >= calls):
                break
            c = Call(i, requests_per_call, now)
            rec.requests_started += requests_per_call
            with span(ENQUEUE_LABEL):
                c.out = enqueue(i)
            c.t_enqueued = time.perf_counter()
            if cuda:
                c.event = torch.cuda.Event()
                c.event.record()
            pending.append(c)
            i += 1
            if len(pending) >= in_flight:
                complete(pending.popleft())
        while pending:
            complete(pending.popleft())
    except Exception as exc:          # a failing call ends the loop; the run reports it
        rec.error = exc
    rec.t_end = time.perf_counter()
    return rec
