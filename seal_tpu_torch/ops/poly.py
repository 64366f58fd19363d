"""Coefficient-wise polynomial ops over the RNS representation.

Port of ``seal_tpu/ops/poly.py`` (counterpart of the reference's
``util/polyarithsmallmod`` and ``util/galois``): int64 data of shape
(..., k, n) against per-limb constants of shape (k, 1).  Galois
automorphisms are gathers over host-built index tables
(``util/galois.cpp:18-51, 148-218``); the tables are built with vectorised
numpy, entry for entry the reference's loops.  The JAX package's one-hot
MXU form of the NTT-domain permutation is a TPU workaround for a slow lane
gather and is not ported: on the card the permutation is one
``index_select``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import u64 as U
from .. import numth


def add(x: torch.Tensor, y: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return U.add_mod(x, y, q)


def sub(x: torch.Tensor, y: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return U.sub_mod(x, y, q)


def negate(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return U.neg_mod(x, q)


def dyadic_product(x: torch.Tensor, y: torch.Tensor, q: torch.Tensor,
                   ratio_lo: torch.Tensor, ratio_hi: torch.Tensor) -> torch.Tensor:
    """Elementwise (x*y) mod q; tolerates lazy inputs < 4q (128-bit Barrett)."""
    return U.mul_mod(x, y, q, ratio_lo, ratio_hi)


def mul_scalar_shoup(x: torch.Tensor, s_op: torch.Tensor, s_qt: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """x * s mod q with host-precomputed Shoup quotient; s < q, x < q."""
    return U.mul_mod_shoup(x, s_op, s_qt, q)


def mul_scalar(x: torch.Tensor, s: torch.Tensor, q: torch.Tensor,
               ratio_lo: torch.Tensor, ratio_hi: torch.Tensor) -> torch.Tensor:
    """x * s mod q via Barrett (for device-computed scalars)."""
    return U.mul_mod(x, s, q, ratio_lo, ratio_hi)


def reduce_coeffs(x: torch.Tensor, q: torch.Tensor, ratio_hi: torch.Tensor) -> torch.Tensor:
    """Reduce arbitrary u64 coefficients into [0, q) (modulo_poly_coeffs)."""
    return U.barrett_reduce_64(x, q, ratio_hi)


def negacyclic_shift(x: torch.Tensor, shift: int, q: torch.Tensor) -> torch.Tensor:
    """Multiply by x^shift in Z_q[X]/(X^n+1): roll, and negate the wrapped
    part (``negacyclic_shift_poly_coeffmod``, polyarithsmallmod.cpp:319-365).
    ``shift`` is taken mod 2n: a shift in [n, 2n) negates everything once
    more."""
    n = x.shape[-1]
    shift = shift % (2 * n)
    extra_neg = shift >= n
    shift = shift % n
    out = x
    if shift:
        rolled = torch.roll(x, shift, dims=-1)
        wrapped = torch.arange(n, device=x.device) < shift
        out = torch.where(wrapped, U.neg_mod(rolled, q), rolled)
    if extra_neg:
        out = U.neg_mod(out, q)
    return out


def mono_multiply(x: torch.Tensor, mono_coeff: torch.Tensor, mono_exponent: int, q: torch.Tensor,
                  ratio_lo: torch.Tensor, ratio_hi: torch.Tensor) -> torch.Tensor:
    """Multiply by (mono_coeff * X^mono_exponent) negacyclically
    (``negacyclic_multiply_poly_mono_coeffmod``): the multiply_plain
    monomial path."""
    return negacyclic_shift(U.mul_mod(x, mono_coeff, q, ratio_lo, ratio_hi), mono_exponent, q)


# ---------------------------------------------------------------------------
# Galois automorphisms
# ---------------------------------------------------------------------------

def _reverse_bits(v: np.ndarray, bits: int) -> np.ndarray:
    """Bit reversal of the low ``bits`` bits of every entry of ``v``."""
    out = np.zeros_like(v)
    for _ in range(bits):
        out = (out << 1) | (v & 1)
        v = v >> 1
    return out


def make_galois_table_coeff(n: int, galois_elt: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host: coefficient-domain permutation for x -> x^elt.

    Returns (src_index int32, negate_flag bool) arrays of length n such
    that ``out[j] = (-1)^negate_flag[j] * in[src_index[j]]``.
    """
    logn = n.bit_length() - 1
    i = np.arange(n, dtype=np.int64)
    index_raw = i * galois_elt
    index = index_raw & (n - 1)
    src = np.zeros(n, dtype=np.int32)
    neg = np.zeros(n, dtype=bool)
    src[index] = i
    neg[index] = ((index_raw >> logn) & 1).astype(bool)
    return src, neg


def make_galois_table_ntt(n: int, galois_elt: int) -> np.ndarray:
    """Host: NTT-domain permutation table, the gather's source indices
    (``GaloisTool::generate_table_ntt``, galois.cpp:18-51)."""
    logn = n.bit_length() - 1
    reversed_i = _reverse_bits(np.arange(n, 2 * n, dtype=np.int64), logn + 1)
    index_raw = ((galois_elt * reversed_i) >> 1) & (n - 1)
    return _reverse_bits(index_raw, logn).astype(np.int32)


def apply_galois_coeff(x: torch.Tensor, src_index: torch.Tensor, negate_flag: torch.Tensor,
                       q: torch.Tensor) -> torch.Tensor:
    """Coefficient-domain automorphism: gather, then negate where flagged."""
    g = x.index_select(-1, src_index)
    return torch.where(negate_flag, U.neg_mod(g, q), g)


def apply_galois_ntt(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """NTT-domain automorphism: one gather along the coefficient axis;
    ``table`` is an int64 index tensor on the data's device."""
    return x.index_select(-1, table)


def get_elt_from_step(step: int, n: int) -> int:
    """Rotation step -> Galois element, a power of the generator 3 mod 2n
    (``GaloisTool::get_elt_from_step``, galois.cpp:53-94)."""
    m = 2 * n
    if step == 0:
        return m - 1
    sign = step < 0
    pos = abs(step)
    if pos >= (n >> 1):
        raise ValueError("step count too large")
    step_count = (n >> 1) - pos if sign else pos
    return pow(3, step_count, m)


def get_elts_all(n: int) -> List[int]:
    """The Galois elements of every power-of-two rotation and the
    conjugation: ``m-1`` and repeated squarings of 3 and of its inverse
    (``GaloisTool::get_elts_all``, galois.cpp:106-131)."""
    m = 2 * n
    logn = n.bit_length() - 1
    elts = [m - 1]
    pos_power = 3
    neg_power = numth.invert_mod(3, m)
    for _ in range(logn - 1):
        elts.append(pos_power)
        pos_power = (pos_power * pos_power) & (m - 1)
        elts.append(neg_power)
        neg_power = (neg_power * neg_power) & (m - 1)
    return elts
