"""RNS bases, base converters and the BEHZ constants (host, exact Python ints).

Port of ``seal_tpu/rns_host.py`` (counterpart of the reference's
``util/rns.{h,cpp}``): the CRT base with its punctured products, compose
and decompose; the fast base converter's change matrix; and the per-level
``RNSTool``: the BEHZ bases of the BFV multiply (B, Bsk = B U {m_sk},
Bsk U {m_tilde}, {t, gamma}), their converters and constants, BGV's exact
conversion q -> {t}, and the modulus-switch constants.  Every constant is an exact Python int computed
once per context level; ``ops/rns.py`` builds the int64 tensors of each
object once per device and keeps them in its ``device_cache``.

Parity with the JAX package (cf. ``rns.cpp:578-788``):
  * B, m_sk and gamma are 60-bit primes (``INTERNAL_MOD_BIT_COUNT``) from
    the descending ``get_primes(2n, 60, count)`` search, skipping q's primes
    and t; m_sk and gamma are the first two, B the rest;
  * B grows by one prime when ``32 + t.bits + log2(q) >= 60 (k + 1)``;
  * m_tilde = 2^32.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from . import numth
from .modulus import INTERNAL_MOD_BIT_COUNT, Modulus


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

    def extend(self, modulus: Modulus) -> "HostRNSBase":
        return HostRNSBase(self.moduli + [modulus])

    def drop(self) -> "HostRNSBase":
        if self.size == 1:
            raise ValueError("cannot drop from base of size 1")
        return HostRNSBase(self.moduli[:-1])

    def decompose(self, value: int) -> List[int]:
        return [value % v for v in self.values]

    def compose(self, residues: Sequence[int]) -> int:
        acc = 0
        for r, inv, p, v in zip(residues, self.inv_punctured, self.punctured_prod, self.values):
            acc = (acc + (r * inv % v) * p) % self.base_prod
        return acc

    def decompose_array(self, values: np.ndarray) -> np.ndarray:
        """(n,) object/int array -> (k, n) uint64."""
        out = np.zeros((self.size, len(values)), dtype=np.uint64)
        for i, q in enumerate(self.values):
            out[i] = np.array([int(v) % q for v in values], dtype=np.uint64)
        return out

    def compose_array(self, residues: np.ndarray) -> List[int]:
        """(k, n) -> list of n Python ints in [0, base_prod):
        sum_i r_i * C_i mod Q with C_i = ((Q/q_i)^-1 mod q_i) * (Q/q_i)."""
        k, n = residues.shape
        if k == 1:
            return [int(v) for v in residues[0]]
        total = np.zeros(n, dtype=object)
        for i in range(k):
            total += residues[i].astype(object) * (self.inv_punctured[i] * self.punctured_prod[i] % self.base_prod)
        return [int(v) % self.base_prod for v in total]


class HostBaseConverter:
    """Fast base conversion ibase -> obase (``BaseConverter``): the change
    matrix ``matrix[j][i] = (Q/q_i) mod p_j``.

    ``prescale`` (per-input-limb ints) folds a factor into the input's
    inverse-punctured scaling, so the BEHZ ``x m_tilde`` step (rns.cpp:1086)
    rides on the conversion's one Shoup multiply:
    ``inv_punct[i] = prescale_i * (Q/q_i)^-1 mod q_i``.
    """

    def __init__(self, ibase: HostRNSBase, obase: HostRNSBase, prescale: Optional[Sequence[int]] = None):
        self.ibase = ibase
        self.obase = obase
        self.prescale = list(prescale) if prescale is not None else None
        self.matrix = [[p % oj for p in ibase.punctured_prod] for oj in obase.values]
        pres = self.prescale or [1] * ibase.size
        self.inv_punct = [inv * (pre % q) % q for inv, q, pre in zip(ibase.inv_punctured, ibase.values, pres)]
        # the exact conversion's constants (``ops/rns.exact_convert_array``):
        # the 2^-128 fixed-point reciprocals floor(2^128 / q_i) as low and
        # high words, and Q mod the first output modulus
        iratio = [(1 << 128) // q for q in ibase.values]
        self.iratio_lo = [r & ((1 << 64) - 1) for r in iratio]
        self.iratio_hi = [r >> 64 for r in iratio]
        self.q_mod_obase0 = ibase.base_prod % obase.values[0]
        # the conversion's device constants, built by ops/rns.py once per device
        self.device_cache: dict = {}


class HostRNSTool:
    """Per-level BEHZ machinery and mod-switch constants (``RNSTool``)."""

    def __init__(self, poly_modulus_degree: int, base_q: HostRNSBase, plain_modulus: Modulus):
        n = poly_modulus_degree
        if n <= 0 or n & (n - 1):
            raise ValueError("poly_modulus_degree must be a power of 2")
        self.n = n
        self.t = plain_modulus
        self.base_q = base_q
        k = base_q.size

        base_B_size = k
        if 32 + self.t.bit_count + base_q.base_prod.bit_length() >= INTERNAL_MOD_BIT_COUNT * (k + 1):
            base_B_size += 1
        count = base_B_size + 2                  # B plus m_sk and gamma
        used = set(base_q.values) | {self.t.value}
        fetch = count
        while True:
            cands = [p for p in numth.get_primes(2 * n, INTERNAL_MOD_BIT_COUNT, fetch) if p not in used]
            if len(cands) >= count:
                primes = cands[:count]
                break
            fetch += count + len(used)
        self.m_sk = Modulus(primes[0])
        self.gamma = Modulus(primes[1])
        self.m_tilde = Modulus(1 << 32)
        self.base_B = HostRNSBase([Modulus(p) for p in primes[2:]])
        self.base_Bsk = self.base_B.extend(self.m_sk)
        self.base_Bsk_m_tilde = self.base_Bsk.extend(self.m_tilde)
        self.base_t_gamma = None if self.t.is_zero else HostRNSBase([self.t, self.gamma])

        # the converters; the m_tilde one is merged and prescaled, so
        # fastbconv_m_tilde is one Shoup multiply and one contraction
        # (rns.cpp:1086-1131), and fastbconv_sk's two conversions (B -> q,
        # B -> m_sk, rns.cpp:903-978) are one contraction to q U {m_sk}
        self.conv_q_to_Bsk = HostBaseConverter(base_q, self.base_Bsk)
        self.conv_q_to_Bsk_m_tilde_scaled = HostBaseConverter(
            base_q, self.base_Bsk_m_tilde, prescale=[self.m_tilde.value] * k)
        self.conv_B_to_q_m_sk = HostBaseConverter(self.base_B, HostRNSBase(list(base_q.moduli) + [self.m_sk]))
        self.conv_q_to_t_gamma = None if self.base_t_gamma is None else HostBaseConverter(base_q, self.base_t_gamma)
        # BGV decryption's exact conversion q -> {t} (``ops/rns.decrypt_modt``)
        self.conv_q_to_t = None if self.t.is_zero else HostBaseConverter(base_q, HostRNSBase([self.t]))

        q_prod = base_q.base_prod
        B_prod = self.base_B.base_prod
        bskv = self.base_Bsk.values
        self.prod_B_mod_q = [B_prod % v for v in base_q.values]
        self.inv_prod_q_mod_Bsk = [numth.invert_mod(q_prod % v, v) for v in bskv]
        self.inv_prod_B_mod_m_sk = numth.invert_mod(B_prod % self.m_sk.value, self.m_sk.value)
        self.inv_m_tilde_mod_Bsk = [numth.invert_mod(self.m_tilde.value % v, v) for v in bskv]
        mt = self.m_tilde.value
        self.neg_inv_prod_q_mod_m_tilde = (-numth.invert_mod(q_prod % mt, mt)) % mt
        self.prod_q_mod_Bsk = [q_prod % v for v in bskv]
        if self.base_t_gamma is not None:
            tv, gv = self.t.value, self.gamma.value
            self.inv_gamma_mod_t = numth.invert_mod(gv % tv, tv)
            self.prod_t_gamma_mod_q = [tv * gv % v for v in base_q.values]
            self.neg_inv_q_mod_t_gamma = [(-numth.invert_mod(q_prod % v, v)) % v for v in (tv, gv)]

        # q_last^{-1} mod q_i (mod switch and rescale)
        q_last = base_q.values[-1]
        self.inv_q_last_mod_q = [numth.invert_mod(q_last, v) for v in base_q.values[:-1]] if k > 1 else []
        if not self.t.is_zero:
            self.inv_q_last_mod_t = numth.invert_mod(q_last, self.t.value)
            self.q_last_mod_t = q_last % self.t.value
        # the device constants of the rescale and the BEHZ steps, built by
        # ops/rns.py once per device
        self.device_cache: dict = {}
