"""Negacyclic NTT table generation (host) and the device table bundle.

Port of ``seal_tpu/ntt_tables.py`` (host counterpart of the reference's
``NTTTables``, ``util/ntt.cpp:241-300``): powers of the minimal primitive
2n-th root psi stored so that each butterfly stage reads a contiguous slice —

  * forward table: slot ``j`` holds ``psi^bitrev(j, log_n)``; stage ``s``
    (with ``m = 2^s`` blocks) reads slots ``[m, 2m)``.
  * inverse table: slot ``bitrev(i-1, log_n) + 1`` holds ``psi^-i``; stages
    read slots sequentially from 1 (sizes n/2, n/4, ..., 1), with ``1/n``
    fused into the last stage.

Each twiddle carries a Shoup quotient ``floor(w << 64 / q)``.  ``LimbTables``
packs the tables of a whole RNS modulus vector into int64 tensors, one per
u64 array (the JAX package splits each into uint32 lo/hi words).  A Shoup
quotient or Barrett word can reach 2^64 - 1: it is stored as the int64 with
the same bits, which is what CUDA code reads as ``uint64_t``.  The four-step
matrices (``MXUTables``) of the JAX package have no counterpart: the card's
NTT kernel runs the butterflies on native 64-bit integers.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from . import numth
from .modulus import Modulus

_MASK64 = (1 << 64) - 1
_HOST_NTT_CACHE = {}


def cached_host_ntt_tables(log_n: int, modulus: Modulus) -> "HostNTTTables":
    """Shared cache: tables depend only on (log_n, q), reused across levels."""
    key = (log_n, modulus.value)
    if key not in _HOST_NTT_CACHE:
        _HOST_NTT_CACHE[key] = HostNTTTables(log_n, modulus)
    return _HOST_NTT_CACHE[key]


class HostNTTTables:
    """Exact-integer NTT tables for one (log_n, q) pair."""

    def __init__(self, log_n: int, modulus: Modulus):
        if not (0 <= log_n <= 17):
            raise ValueError("log_n out of range")
        self.log_n = log_n
        self.n = 1 << log_n
        self.modulus = modulus
        q = modulus.value
        self.root = numth.minimal_primitive_root(2 * self.n, q)
        self.inv_root = numth.invert_mod(self.root, q)

        n, psi, ipsi = self.n, self.root, self.inv_root
        fwd = [1] * n
        power = psi
        for i in range(1, n):
            fwd[numth.reverse_bits(i, log_n)] = power
            power = power * psi % q
        self.root_powers = fwd
        inv = [1] * n
        power = ipsi
        for i in range(1, n):
            inv[numth.reverse_bits(i - 1, log_n) + 1] = power
            power = power * ipsi % q
        self.inv_root_powers = inv
        self.inv_degree = numth.invert_mod(n, q)
        # Last inverse stage fuses 1/n: the y-output root is scaled by 1/n.
        self.scaled_last_inv_root = self.inv_root_powers[n - 1] * self.inv_degree % q if n > 1 else self.inv_degree


def _shoup(operand: int, q: int) -> int:
    return ((operand << 64) // q) & _MASK64


def u64_tensor(values, device=None) -> torch.Tensor:
    """Python ints or a numpy uint64 array -> int64 tensor with the same bits."""
    a = np.asarray(values, dtype=np.uint64)
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).to(device)


class LimbTables(NamedTuple):
    """Device NTT + modulus constants for a vector of k moduli.

    Twiddle tables have shape (k, n); per-limb constants have shape (k, 1)
    so they broadcast over the coefficient axis.  All int64.
    """

    fwd_op: torch.Tensor
    fwd_qt: torch.Tensor
    inv_op: torch.Tensor
    inv_qt: torch.Tensor
    invn_op: torch.Tensor        # 1/n (times inv_scale), (k, 1)
    invn_qt: torch.Tensor
    invn_last_op: torch.Tensor   # last inverse root / n (times inv_scale)
    invn_last_qt: torch.Tensor
    q: torch.Tensor
    two_q: torch.Tensor
    ratio_lo: torch.Tensor       # floor(2^128/q) low u64
    ratio_hi: torch.Tensor       # floor(2^128/q) high u64
    log_n: int = 0
    moduli_values: tuple = ()
    # per-limb scalar folded into the inverse transform's 1/n constants
    inv_scale: tuple = ()

    N_ARRAY_FIELDS = 12  # fields before the metadata tail

    @property
    def device(self) -> torch.device:
        return self.q.device


def build_limb_tables(
    log_n: int,
    moduli: Sequence[Modulus],
    host_tables: "Sequence[HostNTTTables] | None" = None,
    inv_scale: "Sequence[int] | None" = None,
    device=None,
) -> LimbTables:
    """Build the device bundle for a modulus vector.

    ``inv_scale`` (per-limb ints) folds an extra scalar into the inverse
    transform's fused 1/n stage, as ``seal_tpu.ntt_tables.build_limb_tables``
    does.
    """
    if host_tables is None:
        host_tables = [cached_host_ntt_tables(log_n, m) for m in moduli]
    k = len(moduli)
    if inv_scale is None:
        inv_scale = [1] * k

    fwd_op, fwd_qt, inv_op, inv_qt = [], [], [], []
    invn, invn_qt, last, last_qt = [], [], [], []
    for mod, tab, s in zip(moduli, host_tables, inv_scale):
        q = mod.value
        fwd_op.append(tab.root_powers)
        fwd_qt.append([_shoup(w, q) for w in tab.root_powers])
        inv_op.append(tab.inv_root_powers)
        inv_qt.append([_shoup(w, q) for w in tab.inv_root_powers])
        s %= q
        invn.append([tab.inv_degree * s % q])
        invn_qt.append([_shoup(tab.inv_degree * s % q, q)])
        last.append([tab.scaled_last_inv_root * s % q])
        last_qt.append([_shoup(tab.scaled_last_inv_root * s % q, q)])

    qv = [[m.value] for m in moduli]
    ratio = [m.const_ratio for m in moduli]
    arrays = (
        fwd_op, fwd_qt, inv_op, inv_qt, invn, invn_qt, last, last_qt,
        qv, [[2 * v] for (v,) in qv],
        [[r & _MASK64] for r in ratio], [[r >> 64] for r in ratio],
    )
    return LimbTables(
        *(u64_tensor(a, device) for a in arrays),
        log_n=log_n,
        moduli_values=tuple(m.value for m in moduli),
        inv_scale=tuple(int(s) for s in inv_scale),
    )
