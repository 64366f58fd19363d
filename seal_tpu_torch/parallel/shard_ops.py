"""The key-switch contraction with its decomposition axis split over ranks.

Port of ``seal_tpu/parallel/shard_ops.py``: the inner product over
decomposition limbs (evaluator.cpp:2663-2756) becomes per-rank partial sums
plus a collective.  Each rank contracts its own decomposition limbs and
Barrett-reduces its u128 sum to [0, q); the ranks of a limb group then
all-gather the partial sums and add them mod q.  Modular sums cannot ride
a plain sum, so the gather and ``add_mod`` is the exact formulation, and
every rank of the group ends with the same total.

``gather_add_mod`` is the collective step; ``parallel/sharded.py`` runs
it after kernel B's per-rank contraction (``sharded.contract``), which
takes the place of the JAX module's plain per-rank sum.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..ops import u64 as U
from .collectives import all_gather


def gather_add_mod(partials: Sequence[torch.Tensor], qs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One group's partial sums, each below q: every rank gets their sum
    mod q (``qs[i]`` on rank i's device), added in group order."""
    out = []
    for gathered, q in zip(all_gather(partials), qs):
        total = gathered[0]
        for s in range(1, gathered.shape[0]):
            total = U.add_mod(total, gathered[s], q)
        out.append(total)
    return out

