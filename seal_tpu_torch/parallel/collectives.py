"""Collectives over the ranks of one mesh group, in plain PyTorch.

What XLA inserts into a sharded program, or what ``shard_map`` bodies call
(``lax.all_gather``, ``lax.all_to_all``), written out for the port's
single-controller mesh (``parallel/mesh.py``): each function takes the
local tensors of one group of ranks, in the group's order (``DeviceMesh.
group``), and returns each rank's result on that rank's device.  Data moves
by slicing and ``Tensor.to(device)``; ranks that share a device share
memory, so nothing is copied between them that need not be.

The corner turn of the distributed NTT also has a hand-written kernel,
``parallel/remote_ntt.py``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def all_gather(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``lax.all_gather(x, axis)`` (not tiled): every rank gets the stack,
    along a new leading axis, of the group's tensors in group order."""
    return [torch.stack([x.to(dst.device) for x in xs]) for dst in xs]


def all_to_all(xs: Sequence[torch.Tensor], split_axis: int, concat_axis: int) -> List[torch.Tensor]:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=False)``:
    rank m's block j along ``split_axis`` (whose length is the group's size)
    goes to rank j, which stacks the blocks it receives along a new axis at
    ``concat_axis``, in the senders' order."""
    size = len(xs)
    for x in xs:
        if x.shape[split_axis] != size:
            raise ValueError(f"all_to_all over {size} ranks splits an axis of length {size}, "
                             f"got shape {tuple(x.shape)} split at {split_axis}")
    return [torch.stack([x.select(split_axis, j).to(xs[j].device) for x in xs], dim=concat_axis)
            for j in range(size)]


def broadcast(xs: Sequence[torch.Tensor], root: int) -> List[torch.Tensor]:
    """Every rank gets rank ``root``'s tensor (of the group), on its own device."""
    return [xs[root].to(x.device) for x in xs]


def gather_range(pieces: Sequence[torch.Tensor], ranges: Sequence[Tuple[int, int]], lo: int, hi: int,
                 dim: int, device) -> torch.Tensor:
    """Entries [lo, hi) along ``dim`` of a tensor the group holds in pieces,
    ``pieces[i]`` covering ``ranges[i]``, assembled on ``device``.  A range
    that one piece on that device holds comes back as a view of it."""
    device = torch.device(device)
    for piece, (plo, phi) in zip(pieces, ranges):
        if plo <= lo and hi <= phi and piece.device == device:
            return piece.narrow(dim, lo - plo, hi - lo)
    parts, at = [], lo
    for piece, (plo, phi) in sorted(zip(pieces, ranges), key=lambda pr: pr[1]):
        a, b = max(at, plo), min(hi, phi)
        if a < b and a == at:
            parts.append(piece.narrow(dim, a - plo, b - a).to(device))
            at = b
    if at != hi:
        raise ValueError(f"the group's pieces {list(ranges)} do not cover [{lo}, {hi})")
    if not parts:
        shape = list(pieces[0].shape)
        shape[dim] = 0
        return pieces[0].new_empty(shape, device=device)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)
