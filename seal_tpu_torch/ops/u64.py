"""Modular 64-bit arithmetic on int64 tensors (the plain PyTorch versions).

Port of ``seal_tpu/ops/u64.py`` (counterpart of the reference's
``util/uintarithsmallmod.h``: Barrett 64/128-bit reduction, Shoup
multiplication and its lazy form).  A u64 array is ONE ``torch.int64``
tensor holding the same 64 bits; the JAX package's (lo, hi) uint32 pair
does not port, since PyTorch has no uint64 arithmetic on the CPU.  Modular
values stay below 2^62 (at most 4q for q < 2^60), so ordinary int64
addition, subtraction and comparison are exact for them.  Shoup quotients
and Barrett ratio words use all 64 bits and may read as negative int64.

The 64x64 -> 128-bit products are emulated: operands split into 32-bit
words, and each 32x32 product into two 32x16 partial products (< 2^48), so
no intermediate reaches 2^63 and nothing relies on int64 wraparound.  The
CUDA kernels do the same arithmetic with ``__umul64hi`` and
``unsigned __int128``.  A u128 value is a pair ``(lo, hi)`` of u64 tensors.

The modular functions (``add_mod`` to ``mul_mod_shoup``) send a tensor on
the card to kernel E (``ops/cuda_modarith.py``), one launch a call, and
run their plain bodies on the CPU and inside :func:`plain_on_card`.

:func:`plain_on_card` is the one switch between the card's kernels and
their plain versions: inside it, every entry point of the port (keygen,
encryption, the encoder, the evaluator) runs the plain PyTorch versions on
the card too, to check the kernels.  :func:`use_kernels` is what each
dispatch reads; ``ops/ntt.py`` exports both.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch

from .cuda_modarith import modarith_cuda

U128 = Tuple[torch.Tensor, torch.Tensor]

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF
_SIGN = -(1 << 63)

_plain_on_card = False


def use_kernels(x: torch.Tensor) -> bool:
    """True where ``x`` lies on the card and no :func:`plain_on_card` block
    is open: the dispatch then launches the card's kernels."""
    return x.is_cuda and not _plain_on_card


@contextlib.contextmanager
def plain_on_card():
    """Run the plain PyTorch versions on the card inside the block."""
    global _plain_on_card
    before, _plain_on_card = _plain_on_card, True
    try:
        yield
    finally:
        _plain_on_card = before


# ---------------------------------------------------------------------------
# 32-bit words (payloads < 2^32 held in int64)
# ---------------------------------------------------------------------------

def _split(x: torch.Tensor):
    """u64 bit pattern -> (low word, high word), each in [0, 2^32)."""
    return x & _M32, (x >> 32) & _M32


def _join(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(low word, high word) -> u64 bit pattern, without overflow."""
    signed_hi = hi - ((hi >> 31) << 32)          # hi read as a signed 32-bit word
    return signed_hi * (1 << 32) + lo


def _mul32(a: torch.Tensor, b: torch.Tensor):
    """Full 32x32 -> 64 product as (low word, high word)."""
    p0 = a * (b & _M16)                          # < 2^48
    p1 = a * (b >> 16)                           # < 2^48
    t = p0 + ((p1 & _M16) << 16)                 # < 2^49
    return t & _M32, (t >> 32) + (p1 >> 16)


def _words_mul_wide(x: torch.Tensor, y: torch.Tensor):
    """64x64 -> 128 product as four 32-bit words, little-endian."""
    x0, x1 = _split(x)
    y0, y1 = _split(y)
    a0, a1 = _mul32(x0, y0)
    b0, b1 = _mul32(x0, y1)
    c0, c1 = _mul32(x1, y0)
    d0, d1 = _mul32(x1, y1)
    s1 = a1 + b0 + c0                            # < 3 * 2^32
    s2 = (s1 >> 32) + b1 + c1 + d0               # < 4 * 2^32
    return a0, s1 & _M32, s2 & _M32, (s2 >> 32) + d1


def _ge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a >= b on u64 bit patterns."""
    return (a ^ _SIGN) >= (b ^ _SIGN)


def add64_carry(x: torch.Tensor, y: torch.Tensor):
    """x + y mod 2^64 and its carry-out (0 or 1)."""
    x0, x1 = _split(x)
    y0, y1 = _split(y)
    s0 = x0 + y0
    s1 = x1 + y1 + (s0 >> 32)
    return _join(s0 & _M32, s1 & _M32), s1 >> 32


def add64(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x + y mod 2^64."""
    return add64_carry(x, y)[0]


def sub64(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x - y mod 2^64."""
    x0, x1 = _split(x)
    y0, y1 = _split(y)
    d0 = x0 - y0
    borrow = (d0 < 0).to(x0.dtype)
    d1 = x1 - y1 - borrow
    return _join(d0 & _M32, d1 & _M32)


# ---------------------------------------------------------------------------
# u64 multiplication
# ---------------------------------------------------------------------------

def mul64_wide(x: torch.Tensor, y: torch.Tensor) -> U128:
    """Full 64x64 -> 128 product as (lo, hi) u64 halves."""
    w0, w1, w2, w3 = _words_mul_wide(x, y)
    return _join(w0, w1), _join(w2, w3)


def mulhi64(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """High 64 bits of the 128-bit product."""
    _, _, w2, w3 = _words_mul_wide(x, y)
    return _join(w2, w3)


def mullo64(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Low 64 bits of x*y."""
    x0, x1 = _split(x)
    y0, y1 = _split(y)
    a0, a1 = _mul32(x0, y0)
    b0, _ = _mul32(x0, y1)
    c0, _ = _mul32(x1, y0)
    return _join(a0, (a1 + b0 + c0) & _M32)


def add128(a: U128, b: U128) -> U128:
    """Add two u128 values, wrapping mod 2^128."""
    lo, c = add64_carry(a[0], b[0])
    hi = add64(add64(a[1], b[1]), c)
    return lo, hi


# ---------------------------------------------------------------------------
# Modular arithmetic (reference: uintarithsmallmod.h)
# ---------------------------------------------------------------------------

def add_mod(x: torch.Tensor, y: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(x + y) mod q; inputs < q < 2^62."""
    if use_kernels(x):
        return modarith_cuda("add_mod", x, y, q)
    s = x + y
    return torch.where(s >= q, s - q, s)


def sub_mod(x: torch.Tensor, y: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(x - y) mod q; inputs < q < 2^62."""
    if use_kernels(x):
        return modarith_cuda("sub_mod", x, y, q)
    d = x - y
    return torch.where(d < 0, d + q, d)


def neg_mod(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(-x) mod q; input < q (maps 0 -> 0)."""
    if use_kernels(x):
        return modarith_cuda("neg_mod", x, q)
    return torch.where(x != 0, q - x, x)


def barrett_reduce_64(x: torch.Tensor, q: torch.Tensor, ratio_hi: torch.Tensor) -> torch.Tensor:
    """x mod q for any 64-bit x; ratio_hi = floor(2^128/q) >> 64.

    The reference's ``barrett_reduce_64`` (uintarithsmallmod.h:211-236): one
    mulhi, one mullo, one conditional subtraction.
    """
    if use_kernels(x):
        return modarith_cuda("barrett_reduce_64", x, q, ratio_hi)
    red = sub64(x, mullo64(mulhi64(x, ratio_hi), q))     # < 2q
    return torch.where(_ge(red, q), red - q, red)


def barrett_reduce_128(z: U128, q: torch.Tensor, ratio_lo: torch.Tensor, ratio_hi: torch.Tensor) -> torch.Tensor:
    """z mod q for a 128-bit z = (lo, hi); ratio = floor(2^128/q) as two u64.

    Follows ``barrett_reduce_128`` (uintarithsmallmod.h:167-205) step for
    step, as ``seal_tpu.ops.u64.barrett_reduce_128`` does.
    """
    z0, z1 = z
    if use_kernels(z0):
        return modarith_cuda("barrett_reduce_128", z0, z1, q, ratio_lo, ratio_hi)
    carry = mulhi64(z0, ratio_lo)
    tmp2_lo, tmp2_hi = mul64_wide(z0, ratio_hi)
    tmp1, c = add64_carry(tmp2_lo, carry)
    tmp3 = add64(tmp2_hi, c)
    t2lo, t2hi = mul64_wide(z1, ratio_lo)
    _, c = add64_carry(tmp1, t2lo)
    carry2 = add64(t2hi, c)
    quot = add64(add64(mullo64(z1, ratio_hi), tmp3), carry2)
    red = sub64(z0, mullo64(quot, q))                    # < 2q
    return torch.where(_ge(red, q), red - q, red)


def mul_mod(x: torch.Tensor, y: torch.Tensor, q: torch.Tensor,
            ratio_lo: torch.Tensor, ratio_hi: torch.Tensor) -> torch.Tensor:
    """(x*y) mod q via 128-bit Barrett."""
    if use_kernels(x):
        return modarith_cuda("mul_mod", x, y, q, ratio_lo, ratio_hi)
    return barrett_reduce_128(mul64_wide(x, y), q, ratio_lo, ratio_hi)


def mul_mod_shoup_lazy(x: torch.Tensor, y: torch.Tensor, y_quot: torch.Tensor,
                       q: torch.Tensor) -> torch.Tensor:
    """x*y mod q in [0, 2q), with y_quot = floor(y << 64 / q) and y < q."""
    if use_kernels(x):
        return modarith_cuda("mul_mod_shoup_lazy", x, y, y_quot, q)
    return sub64(mullo64(y, x), mullo64(mulhi64(x, y_quot), q))


def mul_mod_shoup(x: torch.Tensor, y: torch.Tensor, y_quot: torch.Tensor,
                  q: torch.Tensor) -> torch.Tensor:
    """x*y mod q with Shoup-precomputed quotient (uintarithsmallmod.h:292-310)."""
    if use_kernels(x):
        return modarith_cuda("mul_mod_shoup", x, y, y_quot, q)
    r = mul_mod_shoup_lazy(x, y, y_quot, q)
    return torch.where(_ge(r, q), r - q, r)
