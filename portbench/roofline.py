"""Peaks of the card and the work of each kernel, counted from shapes.

A frozen copy of ``chip_smoke.py``'s ``bound_ms``, ``ntt_work``,
``switch_key_work`` and ``stage_work`` and their constants.  The work is
the algorithm's: each input read once, each output written once, the
butterflies and products the transform and the contraction need, whatever
the kernel that runs them does, so that any implementation is held to the
same yardstick.
"""

from __future__ import annotations

# Peak rates of one H100 SXM (NVIDIA data sheet, 700 W): HBM bandwidth, and
# the float32 rate outside the tensor cores, taken as the rate of 32-bit
# integer operations.  The card issues INT32 at no more than that rate, so a
# bound computed with it is a lower bound on the time.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
# 32-bit operations counted per u64 operation: a 64x64-bit multiply (low or
# high half) takes four 32x32-bit partial products; an add, subtract or
# compare-and-select takes two.
OPS_MUL64 = 4
OPS_ADD64 = 2
# One Harvey butterfly: three u64 multiplies (Shoup) and six adds,
# subtracts and conditional subtractions.
OPS_BUTTERFLY = 3 * OPS_MUL64 + 6 * OPS_ADD64


def bound_ms(nbytes, ops):
    """The least time the card could take: (ms, 'bytes' or 'operations')."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ntt_work(rows, k, log_n):
    """Bytes and 32-bit operations of one NTT call over rows x n."""
    n = 1 << log_n
    nbytes = 8 * (2 * rows * n + 2 * k * n)          # data in and out, one table pair
    ops = rows * (log_n * (n // 2) * OPS_BUTTERFLY + n * 2 * OPS_ADD64)
    return nbytes, ops


def switch_key_work(D, key_rows, Rn, log_n, diag, B=1):
    """Bytes and 32-bit operations of one kernel-B call over B ciphertexts:
    their rows in (t_c, and t_n with the diagonal), the key's 2 D rows of Rn
    limbs once, the (Rn, n) root table pair, B outputs of 2 Rn rows."""
    n = 1 << log_n
    nbytes = 8 * n * (B * D * (2 if diag else 1) + 2 * D * Rn + 2 * Rn + B * 2 * Rn)
    ntts = D * Rn - (D if diag else 0)
    ops = ntts * log_n * (n // 2) * OPS_BUTTERFLY
    # per (j, i, coefficient): Barrett-64 (2 mul, 2 add), two guards, two
    # 64x64->128 products and two u128 adds; per output: Barrett-128
    ops += D * Rn * n * (2 * OPS_MUL64 + 2 * OPS_ADD64 + 2 * OPS_ADD64 + 2 * OPS_MUL64 + 4 * OPS_ADD64)
    ops += 2 * Rn * n * (5 * OPS_MUL64 + 8 * OPS_ADD64)
    return nbytes, B * ops


def stage_work(rows, k, M, ncols, twiddle):
    """Bytes and 32-bit operations of one four-step stage: an M-point
    transform of each of ``ncols`` columns (its butterflies), plus the
    twiddle.  Bytes: the data in and out, the twiddle pair, and a root table
    pair of M entries per limb, the same rule as kernel A's."""
    n = M * ncols
    nbytes = 8 * (2 * rows * n + 2 * k * M + (2 * k * n if twiddle else 0))
    log_m = M.bit_length() - 1
    ops = rows * ncols * (M // 2) * log_m * OPS_BUTTERFLY
    if twiddle:
        ops += rows * n * (3 * OPS_MUL64 + 2 * OPS_ADD64)
    return nbytes, ops
