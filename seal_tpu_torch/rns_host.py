"""RNS base and mod-switch constants (host, exact Python ints).

Port of the part of ``seal_tpu/rns_host.py`` that the CKKS server path
needs (counterpart of the reference's ``util/rns.{h,cpp}``): the CRT base
with its punctured products, and the rescale constant
``inv_q_last_mod_q``.  The BEHZ machinery (auxiliary bases, base
converters) arrives with the BFV slice.
"""

from __future__ import annotations

from typing import List, Sequence

from . import numth
from .modulus import Modulus


def shoup_pair(operand: int, q: int):
    """(operand, floor(operand << 64 / q)) — a MultiplyUIntModOperand."""
    return operand % q, ((operand % q) << 64) // q


class HostRNSBase:
    """CRT base with punctured products and their inverses (``RNSBase``)."""

    def __init__(self, moduli: Sequence[Modulus]):
        if not moduli:
            raise ValueError("rnsbase cannot be empty")
        vals = [m.value for m in moduli]
        for i, v in enumerate(vals):
            if v == 0:
                raise ValueError("rnsbase is invalid")
            for j in range(i):
                if numth.gcd(v, vals[j]) != 1:
                    raise ValueError("rnsbase is invalid (not coprime)")
        self.moduli = list(moduli)
        self.values = vals
        self.size = len(vals)
        self.base_prod = 1
        for v in vals:
            self.base_prod *= v
        self.punctured_prod = [self.base_prod // v for v in vals]
        self.inv_punctured = []
        for v, p in zip(vals, self.punctured_prod):
            ok, inv = numth.try_invert_mod(p % v, v)
            if not ok:
                raise ValueError("rnsbase is invalid (non-invertible)")
            self.inv_punctured.append(inv)
        # the decode's composition constants, built by ops/crt_compose.py once per device
        self.device_cache: dict = {}

    def decompose(self, value: int) -> List[int]:
        return [value % v for v in self.values]


class HostRNSTool:
    """Per-level mod-switch constants (the rescale's part of ``RNSTool``)."""

    def __init__(self, poly_modulus_degree: int, base_q: HostRNSBase, plain_modulus: Modulus):
        n = poly_modulus_degree
        if n <= 0 or n & (n - 1):
            raise ValueError("poly_modulus_degree must be a power of 2")
        self.n = n
        self.t = plain_modulus
        self.base_q = base_q
        # q_last^{-1} mod q_i (mod switch / rescale), rns_host.py:433
        q_last = base_q.values[-1]
        self.inv_q_last_mod_q = (
            [numth.invert_mod(q_last, v) for v in base_q.values[:-1]] if base_q.size > 1 else []
        )
        # the rescale's device constants, built by ops/rns.py once per device
        self.device_cache: dict = {}
