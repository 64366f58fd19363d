"""Partial sums split over ranks, added mod p across a limb group.

Port of ``seal_tpu/parallel/shard_ops.py``: a sum over RNS limbs that a
limb group holds in pieces becomes per-rank partial sums plus a
collective.  Each rank sums its own limbs and reduces the sum to [0, p);
the ranks of a limb group then all-gather the partial sums and add them
mod p.  Modular sums cannot ride a plain sum, so the gather and
``add_mod`` is the exact formulation, and every rank of the group ends
with the same total.  Two sums take this form:

* the key-switch contraction over decomposition limbs
  (evaluator.cpp:2663-2756): kernel B's per-rank contraction
  (``sharded.contract``), mod the key switch's output moduli;
* the fast base conversions of the BFV multiply (rns.cpp:418-465): the
  partial conversions of a rank's q limbs to Bsk U {m_tilde} and to Bsk
  (``ops/rns.fast_convert_array`` with ``lo``, ``sharded.bfv_multiply``),
  mod those moduli.

``gather_add_mod`` is the collective step, which takes the place of the
JAX module's plain per-rank sum.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..ops import u64 as U
from .collectives import all_gather


def gather_add_mod(partials: Sequence[torch.Tensor], qs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One group's partial sums, each below its modulus: every rank gets
    their sum mod the moduli (``qs[i]``, (k_out, 1) on rank i's device),
    added in group order."""
    out = []
    for gathered, q in zip(all_gather(partials), qs):
        total = gathered[0]
        for s in range(1, gathered.shape[0]):
            total = U.add_mod(total, gathered[s], q)
        out.append(total)
    return out

