"""SEAL_TPU_DEBUG=1 assert mode, the reference's SEAL_DEBUG analog.

Port of ``seal_tpu/debug.py``.  The reference compiles argument and range
assertions into debug builds (``#ifdef SEAL_DEBUG``, e.g. ``util/ntt.h:200-209``
asserting NTT operands < 4q, ``util/defines.h:66`` bounding lazy
accumulation).  The port checks the same contracts at the same seams: the
NTT wrappers (``ops/ntt.forward``/``inverse``, which bracket kernel A on the
card) and the key-switch contraction (``ckks_bodies.key_switch_contract``,
which brackets kernel B).  With ``SEAL_TPU_DEBUG=1`` a check compares on the
tensor's device and reads one flag back, raising :class:`RangeError` on a
violation; with the switch off no check and no read-back runs, so the
launches and the order of work are unchanged.

Usage at a seam::

    from .. import debug
    if debug.enabled():
        debug.check_below(y, 4 * t.q, "ntt_forward_lazy output < 4q")
"""

from __future__ import annotations

import os

import torch


def enabled() -> bool:
    """Whether SEAL_TPU_DEBUG assertions are active, read from the
    environment on every call so the switch can be flipped at any time."""
    return os.environ.get("SEAL_TPU_DEBUG", "0") not in ("", "0")


class RangeError(AssertionError):
    pass


def check_below(x: torch.Tensor, bound, what: str) -> torch.Tensor:
    """Raise :class:`RangeError` unless every element of ``x``, read as a
    u64, is below ``bound`` (a tensor that broadcasts against ``x``, e.g.
    (k, 1) per limb, or an int).  Returns ``x``.  No-op unless
    SEAL_TPU_DEBUG=1."""
    if not enabled():
        return x
    # an int64 below zero is a u64 at or above 2^63, above every bound here
    bad = (x < 0) | (x >= bound)
    if bool(bad.any()):
        raise RangeError(f"SEAL_TPU_DEBUG range violation: {what}")
    return x


def check_below_scalar(x: torch.Tensor, bound: int, what: str) -> torch.Tensor:
    """The same with a Python-int bound below 2^63."""
    if not enabled():
        return x
    return check_below(x, torch.tensor(bound, dtype=torch.int64, device=x.device), what)
