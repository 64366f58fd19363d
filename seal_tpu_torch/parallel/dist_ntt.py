"""Distributed single-transform NTT: the four-step corner turn across ranks.

Port of ``seal_tpu/parallel/dist_ntt.py``.  With the coefficients of one
transform viewed as an (n1, n2) matrix, the four-step factorization
(``ops/four_step.py``) distributes over P ranks of one mesh axis:

    columns split over the ranks
      stage A  : n1-point transform of each column, times the twiddle  -> local
      transpose: columns -> rows                                        -> one exchange
      stage B  : n2-point transform of each row                         -> local

so each coefficient crosses between ranks once.  Each rank's stages are the
port's stage (``stage_cuda``, the hand-written kernel, on a card;
``stage_plain`` on the CPU) on its column shard, ``StageSpec(n1, n1, n2/P,
(n2/P, 1), (n2/P, 1))``, or its row shard, ``StageSpec(n2, n2, n1/P, (1,
n2), (1, n2))``, with the matching shard of the twiddles.  The inverse runs
the same steps backwards.  The output equals the single-device four-step
transform, and so the butterflies, bit for bit.

The exchange is the corner turn (``parallel/remote_ntt.py``): the
hand-written kernel ``csrc/corner_turn.cu`` for ranks on cards, its plain
version, ``all_to_all`` of ``parallel/collectives.py`` copied into place,
on the CPU.  The JAX package's ``exchange`` argument chose between those
two by hand; here the device chooses, as it does for every other kernel.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..ntt_tables import FourStepTables
from ..ops.cuda_four_step import stage_cuda
from ..ops.four_step import StageSpec, stage_plain
from ..ops.ntt import use_kernels
from .mesh import DeviceMesh
from .remote_ntt import corner_turn, remote_corner_turn


def _stage(x, name, ft, spec, twiddle=None):
    return (stage_cuda if use_kernels(x) else stage_plain)(x, name, ft, spec, twiddle)


def _on(ft: FourStepTables, device: torch.device) -> FourStepTables:
    if ft.q.device == device:
        return ft
    return ft._replace(**{f: getattr(ft, f).to(device) for f in ft._fields if isinstance(getattr(ft, f), torch.Tensor)})


class DistNTT:
    """The distributed forward and inverse transform of (k, n) data over the
    ranks of one mesh axis, with each rank's constants built once.

    ``mesh`` is a :class:`DeviceMesh` whose other axes have size 1.  Rank m
    of the axis holds columns [m n2/P, (m+1) n2/P) of the (n1, n2) view
    before the exchange and rows [m n1/P, (m+1) n1/P) after it.
    """

    def __init__(self, ft: FourStepTables, mesh: DeviceMesh, axis: str = "limb"):
        if any(size != 1 for name, size in mesh.shape.items() if name != axis):
            raise ValueError(f"the distributed NTT spans the mesh axis {axis!r}; the other axes of "
                             f"{mesh.shape} must have size 1")
        P = mesh.shape[axis]
        n1, n2 = ft.n1, ft.n2
        if n1 % P or n2 % P:
            raise ValueError(f"the {P} ranks of the mesh axis must divide n1 = {n1} and n2 = {n2}")
        self.ft, self.P = ft, P
        self.devices = [mesh.device(r) for r in mesh.group(0, axis)]
        k, c, r = ft.q.shape[0], n2 // P, n1 // P
        self.cols, self.rows = c, r
        self.spec_cols = StageSpec(n1, n1, c, (c, 1), (c, 1))
        self.spec_rows = StageSpec(n2, n2, r, (1, n2), (1, n2))

        def col_shard(a, m):
            return a.reshape(k, n1, n2)[:, :, m * c:(m + 1) * c].reshape(k, n1 * c)

        def row_shard(a, m):
            return a.reshape(k, n1, n2)[:, m * r:(m + 1) * r].reshape(k, r * n2)

        self.tables, self.tw, self.twi = [], [], []
        for m, dev in enumerate(self.devices):
            self.tables.append(_on(ft, dev))
            self.tw.append(tuple(col_shard(a, m).contiguous().to(dev) for a in (ft.tw_op, ft.tw_qt)))
            self.twi.append(tuple(row_shard(a, m).contiguous().to(dev) for a in (ft.twi_op, ft.twi_qt)))

    def _check(self, x: torch.Tensor):
        k, n = self.ft.q.shape[0], self.ft.n1 * self.ft.n2
        if tuple(x.shape) != (k, n):
            raise ValueError(f"the distributed NTT takes (k, n) = ({k}, {n}) data, got {tuple(x.shape)}")

    # -- on shards --------------------------------------------------------
    def forward_shards(self, cols: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Column shards (k, n1 * n2/P) below 4q -> row shards (k, n1/P * n2) in [0, q)."""
        k, P, r, c = self.ft.q.shape[0], self.P, self.rows, self.cols
        h = [_stage(x, "w", t, self.spec_cols, tw) for x, t, tw in zip(cols, self.tables, self.tw)]
        # h's (k, n1, c) layout is (k, P, r, c): row block j goes to rank j,
        # whose received column blocks flatten, by sender, to its full rows.
        out = remote_corner_turn([a.view(k, P, r, c) for a in h])
        return [_stage(a.view(k, r * P * c), "f", t, self.spec_rows)
                for a, t in zip(out, self.tables)]

    def inverse_shards(self, rows: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Row shards (k, n1/P * n2) below 2q -> column shards (k, n1 * n2/P) in [0, q)."""
        k, P, r, c = self.ft.q.shape[0], self.P, self.rows, self.cols
        ht = [_stage(x, "finv", t, self.spec_rows, twi) for x, t, twi in zip(rows, self.tables, self.twi)]
        back = [torch.empty((k, P, r, c), dtype=torch.int64, device=d) for d in self.devices]
        # ht's (k, r, n2) layout is (k, r, P, c): column block j goes to rank
        # j, which stacks what it receives, by sender, into its full columns.
        corner_turn([a.view(k, r, P, c).transpose(1, 2) for a in ht], [b.transpose(1, 2) for b in back])
        return [_stage(b.view(k, P * r * c), "winv", t, self.spec_cols)
                for b, t in zip(back, self.tables)]

    # -- on whole tensors -------------------------------------------------
    def split_columns(self, x: torch.Tensor) -> List[torch.Tensor]:
        k, c = x.shape[0], self.cols
        v = x.reshape(k, self.ft.n1, self.ft.n2)
        return [v[:, :, m * c:(m + 1) * c].reshape(k, -1).contiguous().to(d) for m, d in enumerate(self.devices)]

    def split_rows(self, x: torch.Tensor) -> List[torch.Tensor]:
        k, r = x.shape[0], self.rows
        v = x.reshape(k, self.ft.n1, self.ft.n2)
        return [v[:, m * r:(m + 1) * r].reshape(k, -1).contiguous().to(d) for m, d in enumerate(self.devices)]

    def join_rows(self, shards: Sequence[torch.Tensor], device) -> torch.Tensor:
        k = shards[0].shape[0]
        return torch.cat([s.view(k, self.rows, self.ft.n2).to(device) for s in shards], dim=1).reshape(k, -1)

    def join_columns(self, shards: Sequence[torch.Tensor], device) -> torch.Tensor:
        k = shards[0].shape[0]
        return torch.cat([s.view(k, self.ft.n1, self.cols).to(device) for s in shards], dim=2).reshape(k, -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Forward negacyclic NTT of (k, n) data below 4q; output in [0, q)
        on ``x``'s device, in the butterflies' bit-reversed order."""
        self._check(x)
        return self.join_rows(self.forward_shards(self.split_columns(x)), x.device)

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse negacyclic NTT of (k, n) data below 2q (1/n folded in);
        output in [0, q) on ``x``'s device."""
        self._check(x)
        return self.join_columns(self.inverse_shards(self.split_rows(x)), x.device)


def dist_ntt_forward(x: torch.Tensor, t: FourStepTables, mesh: DeviceMesh, axis: str = "limb") -> torch.Tensor:
    """Forward negacyclic NTT of (k, n) data, its columns split over the
    ranks of ``axis`` (``seal_tpu/parallel/dist_ntt.py:dist_ntt_forward``)."""
    return DistNTT(t, mesh, axis).forward(x)


def dist_ntt_inverse(x: torch.Tensor, t: FourStepTables, mesh: DeviceMesh, axis: str = "limb") -> torch.Tensor:
    """Inverse negacyclic NTT (1/n folded in), mirroring the forward exchange."""
    return DistNTT(t, mesh, axis).inverse(x)
