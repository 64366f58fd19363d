"""RNS mod-switch operation of the CKKS server path, and table slicing.

Port of the part of ``seal_tpu/ops/rns.py`` the slice needs: the CKKS
rescale ``divide_and_round_q_last_ntt`` (``rns.cpp:830-902``), the constant
helpers ``_c`` / ``_cshoup`` / ``_ratio``, and ``slice_limbs`` /
``take_limbs``.  Base conversion and the BEHZ toolchain arrive with the BFV
slice.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ntt_tables import FourStepSlot, LimbTables, u64_tensor
from ..rns_host import HostRNSTool, shoup_pair
from . import ntt as NTT
from . import u64 as U


def _c(values: Sequence[int], device) -> torch.Tensor:
    """Host ints -> (k, 1) int64 constant on the device."""
    return u64_tensor([[v] for v in values], device)


def _cshoup(values: Sequence[int], qs: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    pairs = [shoup_pair(v, q) for v, q in zip(values, qs)]
    return _c([p[0] for p in pairs], device), _c([p[1] for p in pairs], device)


def _ratio(qs: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    r = [(1 << 128) // q for q in qs]
    return _c([x & ((1 << 64) - 1) for x in r], device), _c([x >> 64 for x in r], device)


class _RescaleConstants:
    """Device constants of one level's rescale, built once per device."""

    def __init__(self, tool: HostRNSTool, device):
        qv = tool.base_q.values
        q_last = qv[-1]
        half = q_last >> 1
        rest = qv[:-1]
        self.half = _c([half], device)
        self.q_last = _c([q_last], device)
        self.rest_q = _c(rest, device)
        self.rest_ratio_hi = _ratio(rest, device)[1]
        # (ct mod q_last) mod q_i — copy when q_i >= q_last (already < q_i)
        self.need_reduce = torch.tensor([[qi < q_last] for qi in rest], device=device)
        self.neg_half = _c([qi - (half % qi) for qi in rest], device)
        self.four_q = _c([qi << 2 for qi in rest], device)
        self.inv_op, self.inv_qt = _cshoup(tool.inv_q_last_mod_q, rest, device)


def _rescale_constants(tool: HostRNSTool, device) -> _RescaleConstants:
    key = ("rescale", str(device))
    if key not in tool.device_cache:
        tool.device_cache[key] = _RescaleConstants(tool, device)
    return tool.device_cache[key]


def divide_and_round_q_last_ntt(x: torch.Tensor, tool: HostRNSTool, tables: LimbTables) -> torch.Tensor:
    """NTT-domain divide-and-round by the last prime (rns.cpp:830-902).

    ``x``: (..., k, n) in NTT form over base q; ``tables`` covers base q.
    Returns (..., k-1, n) in [0, q_i).
    """
    k = tool.base_q.size
    return divide_and_round_q_last_ntt_limbs(x[..., : k - 1, :], x[..., k - 1 :, :], 0, tool, tables)


def divide_and_round_q_last_ntt_limbs(x_rest: torch.Tensor, x_last: torch.Tensor, lo: int,
                                      tool: HostRNSTool, tables: LimbTables) -> torch.Tensor:
    """Limbs [lo, lo + x_rest.shape[-2]) of the rescale, from those limbs of
    the input and its last limb ``x_last`` (..., 1, n): what a rank of a
    mesh that holds those limbs computes.  ``tables`` covers base q."""
    k = tool.base_q.size
    hi = lo + x_rest.shape[-2]
    c = _rescale_constants(tool, x_rest.device)
    last_tab = slice_limbs(tables, k - 1, k)
    rest_tab = slice_limbs(tables, lo, hi)
    rest_q = c.rest_q[lo:hi]

    last_coeff = NTT.inverse(x_last.contiguous(), last_tab)
    last_plus = U.add_mod(last_coeff, c.half, c.q_last)
    reduced = U.barrett_reduce_64(last_plus, rest_q, c.rest_ratio_hi[lo:hi])
    temp = torch.where(c.need_reduce[lo:hi], reduced, last_plus)
    # lazy subtract of half: temp += q_i - (half mod q_i); stays < 2q_i
    temp = NTT.forward(temp + c.neg_half[lo:hi], rest_tab, lazy=True)   # < 4q_i
    # x_i + 4q_i - temp, then Shoup-reduce via multiply
    return U.mul_mod_shoup(x_rest + c.four_q[lo:hi] - temp, c.inv_op[lo:hi], c.inv_qt[lo:hi], rest_q)


def slice_limbs(t: LimbTables, start: int, stop: int) -> LimbTables:
    """Restrict a LimbTables bundle to limbs [start, stop)."""
    na = LimbTables.N_ARRAY_FIELDS
    return LimbTables(
        *(arr[start:stop] for arr in t[:na]),
        log_n=t.log_n, moduli_values=t.moduli_values[start:stop],
        inv_scale=t.inv_scale[start:stop] if t.inv_scale else (),
        four_step=FourStepSlot(t, slice(start, stop)),
    )


def take_limbs(t: LimbTables, indices) -> LimbTables:
    """Gather arbitrary limb rows of a LimbTables bundle."""
    idx = [int(i) for i in indices]
    index = torch.tensor(idx, device=t.device)
    na = LimbTables.N_ARRAY_FIELDS
    return LimbTables(
        *(arr.index_select(0, index) for arr in t[:na]),
        log_n=t.log_n,
        moduli_values=tuple(t.moduli_values[i] for i in idx) if t.moduli_values else (),
        inv_scale=tuple(t.inv_scale[i] for i in idx) if t.inv_scale else (),
        four_step=FourStepSlot(t, idx),
    )
