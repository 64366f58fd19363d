"""Exact CRT composition and the centered double of the CKKS decode.

Port of the decode's semantics: ``HostRNSBase.compose_scaled_centered_double``
(``seal_tpu/rns_host.py:107-264``, the reference's ``ckks.h:683-787``), the
tail that ``seal_tpu/ops/crt_compose.py`` computes on the TPU through int8
digit planes.  The composition is exact integer arithmetic on 32-bit words
held in int64 tensors, on the tensors' device; the conversion to float64 is
the reference's ladder, one 64-bit word at a time, with the same rounding
sequence, so the result has the bits of the JAX package's host ladder.
"""

from __future__ import annotations

import torch

from ..rns_host import HostRNSBase

_M32 = 0xFFFFFFFF


def _words(value: int, count: int):
    return [(value >> (32 * w)) & _M32 for w in range(count)]


def _sub(a, b):
    """Multiword a - b on lists of (n,) 32-bit word tensors; (diff, borrow)."""
    out, borrow = [], 0
    for aw, bw in zip(a, b):
        t = aw - bw - borrow
        out.append(t & _M32)
        borrow = (t >> 32) & 1
    return out, borrow


class _ComposeConstants:
    """Digit matrix and word constants of one base, on one device."""

    def __init__(self, base: HostRNSBase, device):
        k = base.size
        self.W = (base.base_prod.bit_length() + 31) // 32
        wd = (base.base_prod.bit_length() + 15) // 16
        self.planes = wd + 4
        # digits[s, (i, a)] = 16-bit digit (s - a) of the punctured product P_i
        digits = torch.zeros((self.planes, k * 4), dtype=torch.float64)
        for i, p in enumerate(base.punctured_prod):
            for a in range(4):
                for s in range(a, min(a + wd, self.planes)):
                    digits[s, i * 4 + a] = float((p >> (16 * (s - a))) & 0xFFFF)
        self.digits = digits.to(device)
        self.inv_q = torch.tensor([1.0 / v for v in base.values], dtype=torch.float64, device=device)[:, None]
        self.q_words = _words(base.base_prod, self.W + 1)
        self.half_words = _words((base.base_prod + 1) >> 1, self.W + 1)


def _constants(base: HostRNSBase, device) -> _ComposeConstants:
    key = ("compose", str(device))
    if key not in base.device_cache:
        base.device_cache[key] = _ComposeConstants(base, device)
    return base.device_cache[key]


def compose_words(scaled: torch.Tensor, base: HostRNSBase):
    """v = sum_i scaled_i * (Q / q_i) mod Q as W + 1 words of (n,) int64.

    ``scaled``: (k, n), ``scaled[i] = residue_i * (Q/q_i)^-1 mod q_i``.
    """
    c = _constants(base, scaled.device)
    k, n = scaled.shape
    # 16-bit digits of the scaled residues, (k * 4, n); every plane sum
    # is below 4k * 2^32 < 2^53, so the float64 product is exact
    d = torch.stack([(scaled >> (16 * a)) & 0xFFFF for a in range(4)], dim=1).reshape(k * 4, n)
    planes = (c.digits @ d.to(torch.float64)).to(torch.int64)             # (planes, n)
    acc = [torch.zeros(n, dtype=torch.int64, device=scaled.device) for _ in range(c.W + 3)]
    for s in range(c.planes):
        if s >> 1 < len(acc):
            acc[s >> 1] = acc[s >> 1] + (planes[s] << (16 * (s & 1)))
    for w in range(len(acc) - 1):
        acc[w + 1] = acc[w + 1] + (acc[w] >> 32)
        acc[w] = acc[w] & _M32
    # v < k * Q: v / Q = sum_i scaled_i / q_i, estimated from below in float64
    m = torch.floor((scaled.to(torch.float64) * c.inv_q).sum(dim=0)) - 1.0
    m = torch.clamp(m, min=0.0).to(torch.int64)
    sub, carry = [], 0
    for qw in c.q_words + [0] * (len(acc) - len(c.q_words)):
        t = m * qw + carry
        sub.append(t & _M32)
        carry = t >> 32
    acc, _ = _sub(acc, sub)
    q_full = c.q_words + [0] * (len(acc) - len(c.q_words))
    for _ in range(3):
        diff, borrow = _sub(acc, q_full)
        take = borrow == 0
        acc = [torch.where(take, dw, aw) for dw, aw in zip(diff, acc)]
    return acc[: c.W + 1]


def compose_centered_double(scaled: torch.Tensor, base: HostRNSBase, inv_scale: float) -> torch.Tensor:
    """The centered lift of the composed value, as float64 times inv_scale,
    (n,) on the tensors' device (``ckks.h:746-781``)."""
    c = _constants(base, scaled.device)
    words = compose_words(scaled, base)
    _, borrow = _sub(words, c.half_words)
    is_upper = borrow == 0                    # v >= (Q+1)/2: the value is negative
    q_minus_v, _ = _sub([torch.full_like(words[0], qw) for qw in c.q_words], words)
    mag = [torch.where(is_upper, a, b) for a, b in zip(q_minus_v, words)][: c.W]
    # the ladder runs while words remain: a word counts if it or a higher one is nonzero
    nz = torch.stack([w != 0 for w in mag])
    live_from = torch.flip(torch.cumsum(torch.flip(nz.to(torch.int64), [0]), 0), [0]) > 0
    res = torch.zeros_like(words[0], dtype=torch.float64)
    ladder = float(inv_scale)
    for w in range(0, c.W, 2):
        f = mag[w].to(torch.float64)
        live = live_from[w]
        if w + 1 < c.W:
            f = f + mag[w + 1].to(torch.float64) * 4294967296.0
            live = live | live_from[w + 1]
        res = res + torch.where(live, f * ladder, 0.0)
        ladder *= 18446744073709551616.0
    return torch.where(is_upper, -res, res)
