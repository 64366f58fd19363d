"""Coefficient-wise polynomial ops over the RNS representation.

Port of ``seal_tpu/ops/poly.py:23-39`` (counterpart of the reference's
``util/polyarithsmallmod``): int64 data of shape (..., k, n) against
per-limb constants of shape (k, 1).  Galois automorphisms arrive with the
rotation slice.
"""

from __future__ import annotations

import torch

from . import u64 as U


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
