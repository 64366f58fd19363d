"""The CKKS encoder's slot FFT on float64 tensors.

Port of the host FFT ladder of ``seal_tpu/ckks_encoder.py:93-131``
(``_fft_from_rev`` / ``_fft_to_rev``, the complex counterpart of
``util/dwthandler.h``) in native float64.  The JAX package's double-float
device FFT (``ops/slot_fft.py``) works around a TPU without f64 and does not
port.  A complex array is a pair (re, im) of real f64 tensors of shape (n,)
on any device.

Bits.  The ladder the JAX package runs on the host multiplies complex128
arrays with numpy, whose complex multiply on hosts with fused multiply-add
computes ``re = fma(ar, br, -(ai*bi))`` and ``im = fma(ar, bi, ai*br)``.
PyTorch has no fused multiply-add operation, so :func:`fma` builds it from
separate IEEE operations: an exact product (Dekker's split), an exact sum,
and a sum rounded to odd, after which one rounding to nearest gives the
correctly rounded ``a*b + c`` (Boldo and Melquiond, "Emulation of FMA and
correctly rounded sums", IEEE TC 2008).  Every step is one elementwise
operation, so the CPU and the card give the same bits, and those of the JAX
package's ladder.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .. import numth

_SPLITTER = 134217729.0        # 2^27 + 1
_INF = float("inf")

Complex = Tuple[torch.Tensor, torch.Tensor]


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """s + e == a + b exactly, s = RN(a + b) (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a: torch.Tensor):
    t = a * _SPLITTER
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    """p + e == a * b exactly, p = RN(a * b) (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _sum_round_odd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b rounded to odd: exact if representable, else the neighbour of
    the exact sum whose last significand bit is 1."""
    s, e = _two_sum(a, b)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, _INF, -_INF)
    return torch.where((e != 0) & even, torch.nextafter(s, toward), s)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c with one rounding to nearest (no overflow or underflow)."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _sum_round_odd(tl, ul)


def cmul(a: Complex, b: Complex) -> Complex:
    """numpy's complex128 multiply on fused-multiply-add hosts."""
    return fma(a[0], b[0], -(a[1] * b[1])), fma(a[0], b[1], a[1] * b[0])


def root_tables(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The encoder's complex root tables (``ckks.cpp:52-66``): forward slot i
    holds the (bitrev i)-th power of the 2n-th root of unity, inverse slot i
    the conjugate of the (bitrev(i-1)+1)-th, as complex128 arrays."""
    logn = n.bit_length() - 1
    m = n << 1

    def root(k):
        return complex(math.cos(2 * math.pi * k / m), math.sin(2 * math.pi * k / m))

    fwd = np.zeros(n, dtype=np.complex128)
    inv = np.zeros(n, dtype=np.complex128)
    for i in range(1, n):
        fwd[i] = root(numth.reverse_bits(i, logn))
        inv[i] = root(numth.reverse_bits(i - 1, logn) + 1).conjugate()
    return fwd, inv


def _stack(x0: Complex, x1: Complex, n: int) -> Complex:
    return (torch.stack([x0[0], x1[0]], dim=1).reshape(n),
            torch.stack([x0[1], x1[1]], dim=1).reshape(n))


def fft_from_rev(values: Complex, inv_roots: Complex, fix: float) -> Complex:
    """Inverse FFT, bit-reversed input -> natural order, scaled by ``fix``
    (``_fft_from_rev``; the last stage fuses the scale, dwthandler.h:166-189)."""
    re, im = values
    n = re.shape[0]
    offset, gap, m = 1, 1, n >> 1
    while m > 1:
        vr, vi = re.reshape(m, 2, gap), im.reshape(m, 2, gap)
        r = (inv_roots[0][offset:offset + m, None], inv_roots[1][offset:offset + m, None])
        x0 = (vr[:, 0] + vr[:, 1], vi[:, 0] + vi[:, 1])
        x1 = cmul((vr[:, 0] - vr[:, 1], vi[:, 0] - vi[:, 1]), r)
        re, im = _stack(x0, x1, n)
        offset += m
        gap <<= 1
        m >>= 1
    vr, vi = re.reshape(1, 2, gap), im.reshape(1, 2, gap)
    # complex times a real: numpy's multiply by (fix + 0j) rounds each part once
    r = (inv_roots[0][offset:offset + 1, None] * fix, inv_roots[1][offset:offset + 1, None] * fix)
    x0 = ((vr[:, 0] + vr[:, 1]) * fix, (vi[:, 0] + vi[:, 1]) * fix)
    x1 = cmul((vr[:, 0] - vr[:, 1], vi[:, 0] - vi[:, 1]), r)
    return _stack(x0, x1, n)


def fft_to_rev(values: Complex, roots: Complex) -> Complex:
    """Forward FFT, natural order -> bit-reversed (``_fft_to_rev``)."""
    re, im = values
    n = re.shape[0]
    m, gap = 1, n >> 1
    while m < n:
        vr, vi = re.reshape(m, 2, gap), im.reshape(m, 2, gap)
        r = (roots[0][m:2 * m, None], roots[1][m:2 * m, None])
        w = cmul((vr[:, 1], vi[:, 1]), r)
        u = (vr[:, 0], vi[:, 0])
        re, im = _stack((u[0] + w[0], u[1] + w[1]), (u[0] - w[0], u[1] - w[1]), n)
        m <<= 1
        gap >>= 1
    return re, im
