"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the plain
reference (``reference/``) recomputes the sampled calls from the
benchmark's own inputs, regenerated from the seed, and every word of every
output ciphertext is compared with the program's, with its form, scale
and correction factor.  The limits are those of an exact comparison.

A configuration's reference is the class ``Reference`` of the module that
its file's ``reference`` key names (a path from the repository's root
that lies under ``portbench/reference/``), else of
``reference/program.py``.  It is built as ``Reference(config, device,
rounding)``, has the configuration's degree as ``n``, and gives each
operation by the evaluator's method name through ``op(name)``; an
operation takes :class:`~portbench.reference.program.Ct`, ``Plain`` and
``Key`` inputs and returns a ``Ct``.  The module is loaded by its path, so
it imports what it shares by absolute names (``from portbench.reference
import program``).
"""

from __future__ import annotations

import importlib.util
import random
import re
from pathlib import Path
from typing import Dict, List

import torch

from .inputs import Inputs
from .reference.program import Ct, Key, Plain, Reference
from .traffic import key_elements, rotations, run_program

ROOT = Path(__file__).resolve().parents[1]
# the metadata of an output, compared with the reference's
FIELDS = ("ntt_form", "scale", "correction_factor")

# name: (limit, rule); "at most" numbers fail above the limit
LIMITS = {"mismatched_words": (0, "at most"), "metadata_mismatches": (0, "at most"),
          "missing_calls": (0, "at most")}


class Reservoir:
    """A uniform sample of ``size`` completed calls, drawn from the seed."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(int(seed))
        self.seen = 0
        self.items: List[dict] = []

    def offer(self, item: dict) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.items[j] = item


def load_file(path: Path, module_name: str):
    """The module of the Python file at ``path``, loaded by its path."""
    loaded = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(loaded)
    loaded.loader.exec_module(module)
    return module


def reference_class(config: dict) -> type:
    """The configuration's plain reference (see the module's docstring)."""
    path = config.get("reference")
    if path is None:
        return Reference
    home = ROOT / "portbench" / "reference"
    if Path(path).is_absolute() or home not in (ROOT / path).resolve().parents:
        raise ValueError(f"{config['name']}: its reference {path} is not a path under portbench/reference/")
    return load_file(ROOT / path, "portbench_reference_" + re.sub(r"\W", "_", str(path))).Reference


def call_inputs(reference: Reference, inputs: Inputs, mix: dict, call: int, scale: float) -> Dict[str, object]:
    """The shared plaintexts and the keys of call ``call``'s client that
    the mix's program uses, each key made alone from its place in the
    client's set."""
    client = call % mix["clients"]
    out: Dict[str, object] = {name: Plain(inputs.plaintext(name), scale) for name in mix["shared"]}
    for name, kind in mix["client_keys"].items():
        elts = key_elements(kind, reference.n)
        if kind == "relin_keys":
            out[name] = Key(inputs.key(name, client, 0))
        else:
            out[name] = {e: Key(inputs.key(name, client, elts.index(e))) for e in rotations(mix, reference.n)}
    return out


def compare(config: dict, mix: dict, seed: int, sampled: List[dict], device) -> dict:
    """The checked numbers, each {value, limit, rule}, over the sampled
    calls' outputs ({'call', 'data' (B, size, k, n), and the fields of
    ``FIELDS``}); each field that differs from the reference's is one
    metadata mismatch."""
    reference = reference_class(config)(config, device)
    inputs = Inputs(config, seed, device)
    scale = float(config.get("scale", 1.0))
    ntt_form = config["scheme"] != "bfv"
    words = metadata = compared = 0
    for item in sampled:
        keys = call_inputs(reference, inputs, mix, item["call"], scale)
        requests = {name: inputs.ciphertexts(name, item["call"] % mix["clients"], mix["batch"])
                    for name in mix["requests"]}
        got = item["data"]
        for b in range(mix["batch"]):
            regs = {name: Ct(data[b], ntt_form, scale) for name, data in requests.items()}
            want = run_program(reference.op, mix["program"], {**regs, **keys}, mix["output"])
            compared += 1
            if b >= got.shape[0] or tuple(got[b].shape) != tuple(want.data.shape):
                words += want.data.numel()
                metadata += 1
                continue
            words += int((got[b].to(want.data.device) != want.data).sum())
            metadata += sum(item.get(f) != getattr(want, f) for f in FIELDS)
    values = {"mismatched_words": words, "metadata_mismatches": metadata,
              "missing_calls": max(0, mix["check_calls"] - len(sampled))}
    checks = {name: {"value": v, "limit": LIMITS[name][0], "rule": LIMITS[name][1]} for name, v in values.items()}
    checks["compared_requests"] = {"value": compared, "limit": mix["check_calls"] * mix["batch"], "rule": "at least"}
    return checks


def passed(checks: dict) -> bool:
    ok = True
    for c in checks.values():
        ok &= c["value"] <= c["limit"] if c["rule"] == "at most" else c["value"] >= c["limit"]
    return bool(ok)


def lines(checks: dict) -> List[str]:
    return [f"check {name}: {c['value']} ({c['rule']} {c['limit']})" for name, c in checks.items()]


def free_cuda() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
