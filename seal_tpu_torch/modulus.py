"""Modulus type and parameter factories.

Port of ``seal_tpu/modulus.py`` (counterpart of the reference's
``native/src/seal/modulus.{h,cpp}``): a ``Modulus`` is host-side metadata
(value, bit count, Barrett ratio as exact Python ints) from which the
context builder derives the device's int64 constant tensors.  The factories
reproduce the reference's deterministic prime sampling, so identical
requests give identical parameter sets in both packages.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from functools import reduce
from typing import Iterable, List, Sequence

from . import numth
from .default_params import (
    DEFAULT_COEFF_MODULUS_128,
    DEFAULT_COEFF_MODULUS_192,
    DEFAULT_COEFF_MODULUS_256,
)

MOD_BIT_COUNT_MAX = 61          # Modulus representation limit (util/defines.h:33)
MOD_BIT_COUNT_MIN = 2
USER_MOD_BIT_COUNT_MAX = 60     # user coeff moduli (util/defines.h:40)
USER_MOD_BIT_COUNT_MIN = 2
# The BEHZ bases' internal primes (Bsk, m_sk, gamma): 60 bits, as the JAX
# package chose (``seal_tpu/modulus.py:39``; the reference's 61 would give
# other primes, and every Bsk residue would differ).
INTERNAL_MOD_BIT_COUNT = 60
PLAIN_MOD_BIT_COUNT_MAX = 60
PLAIN_MOD_BIT_COUNT_MIN = 2
COEFF_MOD_COUNT_MAX = 256
COEFF_MOD_COUNT_MIN = 1
POLY_MOD_DEGREE_MAX = 131072
POLY_MOD_DEGREE_MIN = 2
CIPHERTEXT_SIZE_MAX = 16
CIPHERTEXT_SIZE_MIN = 2


class SecurityLevel(enum.IntEnum):
    """HomomorphicEncryption.org security level (cf. ``sec_level_type``)."""

    NONE = 0
    TC128 = 128
    TC192 = 192
    TC256 = 256


# Max total log2(q) per (security, N): util/hestdparms.h:19-145 (classical).
_HE_STD_PARMS = {
    SecurityLevel.TC128: {1024: 27, 2048: 54, 4096: 109, 8192: 218, 16384: 438, 32768: 881},
    SecurityLevel.TC192: {1024: 19, 2048: 37, 4096: 75, 8192: 152, 16384: 305, 32768: 611},
    SecurityLevel.TC256: {1024: 14, 2048: 29, 4096: 58, 8192: 118, 16384: 237, 32768: 476},
}

HE_STD_ERROR_STD_DEV = 3.2
NOISE_MAX_DEVIATION = HE_STD_ERROR_STD_DEV * 6  # util/globals.h noise_max_deviation


@dataclass(frozen=True)
class Modulus:
    """An up-to-61-bit modulus with its Barrett constant floor(2^128 / q)."""

    value: int

    def __post_init__(self):
        v = self.value
        if v != 0:
            if v >> MOD_BIT_COUNT_MAX or v < 2:
                raise ValueError(f"modulus value {v} out of range")

    @property
    def bit_count(self) -> int:
        return self.value.bit_length()

    @property
    def is_zero(self) -> bool:
        return self.value == 0

    @property
    def const_ratio(self) -> int:
        """floor(2^128 / value); 0 for a zero modulus."""
        if self.value == 0:
            return 0
        return (1 << 128) // self.value

    @property
    def is_prime(self) -> bool:
        return numth.is_prime(self.value)

    def reduce(self, value: int) -> int:
        if self.value == 0:
            raise ValueError("cannot reduce modulo zero")
        return value % self.value


class CoeffModulus:
    """Static factories for RNS coefficient modulus chains."""

    @staticmethod
    def max_bit_count(poly_modulus_degree: int, sec_level: SecurityLevel = SecurityLevel.TC128) -> int:
        if sec_level == SecurityLevel.NONE:
            return COEFF_MOD_COUNT_MAX * MOD_BIT_COUNT_MAX
        return _HE_STD_PARMS.get(sec_level, {}).get(poly_modulus_degree, 0)

    @staticmethod
    def bfv_default(poly_modulus_degree: int, sec_level: SecurityLevel = SecurityLevel.TC128) -> List[Modulus]:
        tables = {
            SecurityLevel.TC128: DEFAULT_COEFF_MODULUS_128,
            SecurityLevel.TC192: DEFAULT_COEFF_MODULUS_192,
            SecurityLevel.TC256: DEFAULT_COEFF_MODULUS_256,
        }
        if sec_level not in tables:
            raise ValueError("invalid security level for BFVDefault")
        table = tables[sec_level]
        if poly_modulus_degree not in table:
            raise ValueError("poly_modulus_degree is not supported by BFVDefault")
        return [Modulus(v) for v in table[poly_modulus_degree]]

    @staticmethod
    def create(poly_modulus_degree: int, bit_sizes: Sequence[int], plain_modulus: "Modulus | int | None" = None) -> List[Modulus]:
        """Sample distinct NTT-friendly primes, largest-bit-size groups first.

        Mirrors ``Modulus::Create`` (``modulus.cpp``): primes == 1 mod 2N (or
        mod lcm(2N, t) when a plain modulus is given), sampled per distinct
        bit size in descending search order, assigned back in input order.
        """
        if not (POLY_MOD_DEGREE_MIN <= poly_modulus_degree <= POLY_MOD_DEGREE_MAX) or (
            poly_modulus_degree & (poly_modulus_degree - 1)
        ):
            raise ValueError("poly_modulus_degree must be a power of 2 in range")
        if not (COEFF_MOD_COUNT_MIN <= len(bit_sizes) <= COEFF_MOD_COUNT_MAX):
            raise ValueError("bit_sizes is invalid")
        if any(b > USER_MOD_BIT_COUNT_MAX or b < USER_MOD_BIT_COUNT_MIN for b in bit_sizes):
            raise ValueError("bit_sizes is invalid")

        factor = 2 * poly_modulus_degree
        if plain_modulus is not None:
            t = plain_modulus.value if isinstance(plain_modulus, Modulus) else int(plain_modulus)
            if t != 0:
                factor = factor * t // math.gcd(factor, t)

        count_table = {}
        for size in bit_sizes:
            count_table[size] = count_table.get(size, 0) + 1
        prime_table = {size: numth.get_primes(factor, size, count) for size, count in count_table.items()}
        return [Modulus(prime_table[size].pop(0)) for size in bit_sizes]


class PlainModulus:
    """Static factories for plaintext moduli (cf. ``PlainModulus`` in modulus.h)."""

    @staticmethod
    def batching(poly_modulus_degree: int, bit_size: int) -> Modulus:
        """A prime of ``bit_size`` bits congruent to 1 mod 2N, so the
        BatchEncoder's mod-t NTT exists."""
        return CoeffModulus.create(poly_modulus_degree, [bit_size])[0]

    @staticmethod
    def batching_many(poly_modulus_degree: int, bit_sizes: Sequence[int]) -> List[Modulus]:
        return CoeffModulus.create(poly_modulus_degree, bit_sizes)


def product(moduli: Iterable[Modulus]) -> int:
    """The product of the moduli's values (1 for none)."""
    return reduce(lambda a, m: a * m.value, moduli, 1)
