"""BFV's multiplication by the BEHZ method (Bajard, Eynard, Hasan and
Zucca, 2016), as Microsoft SEAL computes it (``evaluator.cpp``
``bfv_multiply``, ``rns.cpp`` ``RNSTool``), in exact arithmetic.

The auxiliary bases come from the data primes alone: m_sk, gamma and the
primes of B are the largest 61-bit primes that are 1 mod 2n (B gets one
more prime when the product would not fit), and m_tilde is 2^32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from . import ntt as NTT
from .arith import MASK32, addmod, col, mulmod, primes_below, reduce, submod

AUX_BITS = 61
M_TILDE = 1 << 32


class Bases:
    """The constants of ``RNSTool::initialize`` for data primes q at degree n
    and plain modulus t."""

    def __init__(self, q: Sequence[int], n: int, t: int):
        self.q = [int(p) for p in q]
        k = len(self.q)
        prod_q = math.prod(self.q)
        b_size = k + (1 if 32 + t.bit_length() + prod_q.bit_length() >= AUX_BITS * k + AUX_BITS else 0)
        aux = primes_below(2 * n, AUX_BITS, b_size + 2)
        self.m_sk, self.B = aux[0], aux[2:]             # aux[1] is gamma, BFV decryption's, unused here
        self.Bsk = self.B + [self.m_sk]
        prod_B = math.prod(self.B)
        self.neg_inv_q_mod_mt = (-pow(prod_q, -1, M_TILDE)) % M_TILDE
        self.prod_q_mod_Bsk = [prod_q % m for m in self.Bsk]
        self.inv_mt_mod_Bsk = [pow(M_TILDE, -1, m) for m in self.Bsk]
        self.inv_q_mod_Bsk = [pow(prod_q, -1, m) for m in self.Bsk]
        self.inv_B_mod_msk = pow(prod_B, -1, self.m_sk)
        self.prod_B_mod_q = [prod_B % p for p in self.q]


def fast_convert(x: torch.Tensor, ibase: Sequence[int], obase: Sequence[int]) -> torch.Tensor:
    """``BaseConverter::fast_convert_array``: (..., len(ibase), n) residues
    -> (..., len(obase), n): sum_i [x_i (P/p_i)^-1]_{p_i} (P/p_i) mod each
    output modulus (a power of two is allowed among them)."""
    dev = x.device
    P = math.prod(ibase)
    inv_punct = col([pow(P // p, -1, p) for p in ibase], dev)
    temp = mulmod(x, inv_punct, col(ibase, dev))
    outs = []
    for m in obase:
        acc = torch.zeros_like(temp[..., 0, :])
        if m == M_TILDE:
            for i, p in enumerate(ibase):
                acc = (acc + (temp[..., i, :] & MASK32) * ((P // p) % m)) & MASK32
        else:
            mt = torch.tensor(m, dtype=torch.int64, device=dev)
            for i, p in enumerate(ibase):
                factor = torch.tensor((P // p) % m, dtype=torch.int64, device=dev)
                acc = addmod(acc, mulmod(reduce(temp[..., i, :], mt), factor, mt), mt)
        outs.append(acc)
    return torch.stack(outs, dim=-2)


def extend_to_bsk(c: torch.Tensor, bases: Bases) -> torch.Tensor:
    """Steps (1)-(2): ``fastbconv_m_tilde`` then ``sm_mrq``: (..., k, n)
    coefficients mod q -> (..., |Bsk|, n)."""
    dev = c.device
    q = col(bases.q, dev)
    scaled = mulmod(c, reduce(torch.full_like(q, M_TILDE), q), q)
    conv = fast_convert(scaled, bases.q, bases.Bsk + [M_TILDE])
    to_bsk, r = conv[..., :-1, :], conv[..., -1:, :]
    r = (r * bases.neg_inv_q_mod_mt) & MASK32                                  # (..., 1, n)
    m = col(bases.Bsk, dev)
    lifted = torch.where(r >= M_TILDE // 2, r + (m - M_TILDE), r)               # (..., |Bsk|, n)
    out = addmod(to_bsk, mulmod(col(bases.prod_q_mod_Bsk, dev).expand_as(lifted), lifted, m), m)
    return mulmod(out, col(bases.inv_mt_mod_Bsk, dev), m)


def fast_floor(zq: torch.Tensor, zb: torch.Tensor, bases: Bases) -> torch.Tensor:
    """Step (7): floor(z / q) approximately, into Bsk."""
    m = col(bases.Bsk, zq.device)
    conv = fast_convert(zq, bases.q, bases.Bsk)
    return mulmod(submod(zb, conv, m), col(bases.inv_q_mod_Bsk, zq.device), m)


def shenoy_kumaresan(y: torch.Tensor, bases: Bases) -> torch.Tensor:
    """Step (8): ``fastbconv_sk``, Bsk -> q, exactly (the m_sk limb fixes
    the conversion's overflow)."""
    dev = y.device
    kb = len(bases.B)
    yb = y[..., :kb, :]
    conv_q = fast_convert(yb, bases.B, bases.q)
    conv_msk = fast_convert(yb, bases.B, [bases.m_sk])
    msk = torch.tensor(bases.m_sk, dtype=torch.int64, device=dev)
    alpha = mulmod(submod(conv_msk, y[..., kb:kb + 1, :], msk),
                   torch.tensor(bases.inv_B_mod_msk, dtype=torch.int64, device=dev), msk)   # (..., 1, n)
    q = col(bases.q, dev)
    neg = alpha > (bases.m_sk >> 1)
    mag = reduce(torch.where(neg, msk - alpha, alpha), q)                           # (..., k, n)
    pb = col(bases.prod_B_mod_q, dev)
    coef = torch.where(neg, pb.expand_as(mag), (q - pb).expand_as(mag))
    return addmod(conv_q, mulmod(coef, mag, q), q)


def multiply(c1: torch.Tensor, c2: torch.Tensor, primes: Sequence[int], n: int, t: int) -> torch.Tensor:
    """(2, k, n) x (2, k, n) coefficient-form ciphertexts over primes[:k]
    -> (3, k, n), the BEHZ product."""
    dev = c1.device
    k = c1.shape[-2]
    bases = Bases(primes[:k], n, t)
    joint = list(bases.q) + bases.Bsk
    tab = NTT.tables(joint, n, dev)
    qj = col(joint, dev)

    def lift(c):
        return NTT.forward(torch.cat([c, extend_to_bsk(c, bases)], dim=-2), tab)

    a, b = lift(c1), lift(c2)
    prod = torch.stack([mulmod(a[0], b[0], qj),
                        addmod(mulmod(a[0], b[1], qj), mulmod(a[1], b[0], qj), qj),
                        mulmod(a[1], b[1], qj)])
    z = mulmod(NTT.inverse(prod, tab), reduce(torch.full_like(qj, t), qj), qj)      # (3, k + |Bsk|, n)
    return shenoy_kumaresan(fast_floor(z[..., :k, :], z[..., k:, :], bases), bases)
