"""Exact arithmetic mod primes below 2^61, in plain PyTorch int64.

A residue is an int64 tensor in [0, q).  A product of two residues needs up
to 122 bits; :func:`mulmod` splits the second factor at bit 30 and reduces
each partial product ``a * c`` (``c < 2^31``) by a quotient estimated in
float64.  That estimate is off by at most one, so the remainder, taken from
the wrapped low 64 bits of ``a * c - est * q``, lies in [-q, 2q) and one
conditional add or subtract makes it exact.  Nothing here is shared with the
program under test: the program reduces by Barrett over 32-bit words.

The host side (prime tests, inverses, roots) uses Python integers.
"""

from __future__ import annotations

import torch

_LOW30 = (1 << 30) - 1
MASK32 = (1 << 32) - 1


def _mul_small(a: torch.Tensor, c, q: torch.Tensor) -> torch.Tensor:
    """a * c mod q for a in [0, q), 0 <= c < 2^31 (a tensor or an int)."""
    c_f = c.double() if isinstance(c, torch.Tensor) else float(c)
    est = torch.floor(a.double() * c_f / q.double()).long()
    r = a * c - est * q
    r = torch.where(r < 0, r + q, r)
    return torch.where(r >= q, r - q, r)


def mulmod(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """a * b mod q, exactly, for a, b in [0, q) and q < 2^61 (broadcasting)."""
    hi = _mul_small(_mul_small(a, b >> 30, q), 1 << 30, q)
    return addmod(hi, _mul_small(a, b & _LOW30, q), q)


def addmod(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    s = a + b
    return torch.where(s >= q, s - q, s)


def submod(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.where(d < 0, d + q, d)


def reduce(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """x mod q for 0 <= x < 2^63."""
    return torch.remainder(x, q)


# ---- host integers ----------------------------------------------------------

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(m: int) -> bool:
    """Miller-Rabin with the first twelve primes as bases: exact below 2^64."""
    if m < 2:
        return False
    for p in _MR_BASES:
        if m % p == 0:
            return m == p
    d, s = m - 1, 0
    while d % 2 == 0:
        d, s = d // 2, s + 1
    for a in _MR_BASES:
        x = pow(a, d, m)
        if x in (1, m - 1):
            continue
        for _ in range(s - 1):
            x = x * x % m
            if x == m - 1:
                break
        else:
            return False
    return True


def primes_below(factor: int, bits: int, count: int) -> list:
    """The ``count`` largest primes of ``bits`` bits that are 1 mod ``factor``,
    largest first: ``util/numth.cpp`` ``get_primes`` of Microsoft SEAL."""
    value = ((1 << bits) - 1) // factor * factor + 1
    lower = 1 << (bits - 1)
    out = []
    while len(out) < count and value > lower:
        if is_prime(value):
            out.append(value)
        value -= factor
    if len(out) < count:
        raise ValueError(f"not enough {bits}-bit primes congruent to 1 mod {factor}")
    return out


def minimal_primitive_root(order: int, q: int) -> int:
    """The smallest primitive ``order``-th root of unity mod prime q, for
    ``order`` a power of two dividing q - 1 (``try_minimal_primitive_root``)."""
    if (q - 1) % order:
        raise ValueError(f"{q} is not 1 mod {order}")
    cofactor = (q - 1) // order
    x = 2
    while True:
        g = pow(x, cofactor, q)
        if pow(g, order // 2, q) == q - 1:
            break
        x += 1
    best, cur, g2 = g, g, g * g % q
    for _ in range(order // 2):
        best = min(best, cur)
        cur = cur * g2 % q
    return best


def col(values, device) -> torch.Tensor:
    """A (len, 1) int64 column of host integers, for broadcasting over limbs."""
    return torch.tensor([int(v) for v in values], dtype=torch.int64, device=device).reshape(-1, 1)
