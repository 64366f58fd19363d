"""Host-side number theory over Python arbitrary-precision integers.

Port of ``seal_tpu/numth.py`` (itself the counterpart of microsoft/SEAL
``native/src/seal/util/numth.{h,cpp}``).  All table precomputation runs on
the host, where Python ints give exact arithmetic; only the results (prime
lists, root tables, Barrett ratios) ship to the device, as int64 tensors.

Behavioral parity notes:
  * ``get_primes`` reproduces the reference's deterministic descending search
    (``numth.cpp:278-311``): start at ``(2^bits - 1) // factor * factor + 1``
    and step down by ``factor``.
  * ``minimal_primitive_root`` returns the *smallest* primitive ``degree``-th
    root of unity mod q, which is what the reference's randomized
    ``try_minimal_primitive_root`` (``numth.cpp:386-407``) deterministically
    converges to (it takes the min over all odd powers of any primitive root).
  * ``is_prime`` uses deterministic Miller-Rabin witnesses valid for all
    64-bit inputs instead of the reference's randomized rounds
    (``numth.cpp:180-275``) — same accept/reject behavior on < 2^64.
"""

from __future__ import annotations

from typing import List, Tuple

# Deterministic Miller-Rabin witness set, correct for all n < 3.3e24 > 2^64.
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(value: int) -> bool:
    """Deterministic primality test for 64-bit integers."""
    if value < 2:
        return False
    for p in _MR_WITNESSES:
        if value == p:
            return True
        if value % p == 0:
            return False
    d = value - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, value)
        if x == 1 or x == value - 1:
            continue
        for _ in range(r - 1):
            x = (x * x) % value
            if x == value - 1:
                break
        else:
            return False
    return True


def xgcd(x: int, y: int) -> Tuple[int, int, int]:
    """Extended GCD; returns (g, a, b) with a*x + b*y = g."""
    prev_a, a = 1, 0
    prev_b, b = 0, 1
    while y != 0:
        q = x // y
        x, y = y, x - q * y
        prev_a, a = a, prev_a - q * a
        prev_b, b = b, prev_b - q * b
    return x, prev_a, prev_b


def try_invert_mod(value: int, modulus: int) -> Tuple[bool, int]:
    """Modular inverse; mirrors reference semantics (False if not coprime)."""
    if modulus <= 1:
        raise ValueError("modulus must be at least 2")
    if value == 0:
        return False, 0
    g, a, _ = xgcd(value % modulus, modulus)
    if g != 1:
        return False, 0
    return True, a % modulus


def invert_mod(value: int, modulus: int) -> int:
    ok, inv = try_invert_mod(value, modulus)
    if not ok:
        raise ValueError(f"{value} is not invertible mod {modulus}")
    return inv


def gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


_PRIME_SEARCH_CACHE: dict = {}  # (factor, bit_size) -> [found primes..., next candidate]


def get_primes(factor: int, bit_size: int, count: int) -> List[int]:
    """NTT-friendly primes == 1 mod factor, descending from 2^bit_size.

    Deterministic search identical in order to the reference
    (``numth.cpp:278-311``) so generated parameter sets match.  The search
    position is memoized per (factor, bit_size) since every context level
    re-runs the same descending scan.
    """
    if count <= 0:
        raise ValueError("count must be positive")
    if not (2 <= bit_size <= 61):
        raise ValueError("bit_size must be in [2, 61]")
    key = (factor, bit_size)
    found, value = _PRIME_SEARCH_CACHE.get(
        key, ([], ((1 << bit_size) - 1) // factor * factor + 1)
    )
    lower_bound = 1 << (bit_size - 1)
    while len(found) < count and value > lower_bound:
        if is_prime(value):
            found.append(value)
        value -= factor
    _PRIME_SEARCH_CACHE[key] = (found, value)
    if len(found) < count:
        raise RuntimeError("failed to find enough qualifying primes")
    return list(found[:count])


def get_prime(factor: int, bit_size: int) -> int:
    return get_primes(factor, bit_size, 1)[0]


def is_primitive_root(root: int, degree: int, modulus: int) -> bool:
    """Is root a primitive degree-th root of unity mod modulus (degree = 2^k)?"""
    if root == 0:
        return False
    return pow(root, degree >> 1, modulus) == modulus - 1


def _any_primitive_root(degree: int, modulus: int) -> int:
    """Find some primitive degree-th root of unity mod a prime modulus.

    Deterministic: walks candidates 2,3,... raising to the quotient-group
    power; succeeds quickly since half the group elements work.
    """
    group_size = modulus - 1
    if group_size % degree != 0:
        raise ValueError("no primitive root of requested degree exists")
    quotient = group_size // degree
    for candidate in range(2, 1 << 20):
        root = pow(candidate, quotient, modulus)
        if is_primitive_root(root, degree, modulus):
            return root
    raise RuntimeError("failed to find a primitive root")


def minimal_primitive_root(degree: int, modulus: int) -> int:
    """Smallest primitive degree-th root of unity mod modulus.

    Matches the reference's deterministic output (``numth.cpp:386-407``):
    minimum over all odd powers (= all primitive roots) of any one root.
    """
    root = _any_primitive_root(degree, modulus)
    generator_sq = (root * root) % modulus
    current = root
    best = root
    for _ in range(0, degree, 2):
        if current < best:
            best = current
        current = (current * generator_sq) % modulus
    return best


def naf(value: int) -> List[int]:
    """Non-adjacent form decomposition of a signed integer.

    Mirrors the reference's ``naf()`` (``numth.cpp``): returns signed powers
    of two (each entry is +/- 2^i) summing to ``value``; used by rotation-step
    decomposition.
    """
    res: List[int] = []
    sign = -1 if value < 0 else 1
    value = abs(value)
    i = 0
    while value:
        zi = value % 4
        if zi == 1:
            res.append(sign * (1 << i))
            value -= 1
        elif zi == 3:
            res.append(sign * -(1 << i))
            value += 1
        value >>= 1
        i += 1
    return res


def reverse_bits(value: int, bit_count: int) -> int:
    """Bit reversal of the low bit_count bits."""
    result = 0
    for _ in range(bit_count):
        result = (result << 1) | (value & 1)
        value >>= 1
    return result
