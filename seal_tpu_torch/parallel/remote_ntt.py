"""The corner turn of the distributed NTT, on the card's kernel.

Port of ``seal_tpu/parallel/remote_ntt.py``.  The distributed four-step NTT
(``parallel/dist_ntt.py``) exchanges data across ranks once, at the
transpose between its two stages, and runs that exchange here: rank m's
block j goes straight into rank j's output, by the hand-written kernel
``csrc/corner_turn.cu`` (``ops/cuda_corner_turn.py``) for tensors on
cards, by its plain version (the collective
``parallel/collectives.all_to_all`` copied into place) on the CPU.  The
JAX package's remote-DMA prototype never ran
(``seal_tpu/parallel/remote_ntt.py:12-18``); this one runs wherever the
ranks are on cards, one card or several.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..ops.cuda_corner_turn import corner_turn_cuda
from ..ops.ntt import use_kernels
from .collectives import all_to_all


def corner_turn_plain(srcs: Sequence[torch.Tensor], dsts: Sequence[torch.Tensor]) -> None:
    """Store ``srcs[m][:, j]`` into ``dsts[j][:, :, m]`` for every pair of
    ranks: ``all_to_all(split_axis=1, concat_axis=2)`` copied into the
    destinations.  Sources are (k, P, r, c), destinations (k, r, P, c)."""
    for dst, block in zip(dsts, all_to_all(srcs, 1, 2)):
        dst.copy_(block)


def corner_turn(srcs: Sequence[torch.Tensor], dsts: Sequence[torch.Tensor]) -> None:
    """The kernel for tensors on cards, the plain version on the CPU (or on
    the card inside ``ops.ntt.plain_on_card()``)."""
    if use_kernels(srcs[0]):
        corner_turn_cuda(srcs, dsts)
    else:
        corner_turn_plain(srcs, dsts)


def remote_corner_turn(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every rank's (k, P, r, c) block-split tensor -> (k, r, P, c), block j
    of rank m landing in rank j's slot m: the twin of
    ``lax.all_to_all(a, axis, split_axis=1, concat_axis=2, tiled=False)``
    (``seal_tpu/parallel/remote_ntt.py:64-83``).  ``shards`` are one group's
    tensors in rank order."""
    k, P, r, c = shards[0].shape
    outs = [torch.empty((k, r, P, c), dtype=s.dtype, device=s.device) for s in shards]
    corner_turn(shards, outs)
    return outs
