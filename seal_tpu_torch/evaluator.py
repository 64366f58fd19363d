"""Evaluator: the CKKS server path (multiply, relinearize, rescale).

Port of the CKKS part of ``seal_tpu/evaluator.py`` (counterpart of
``evaluator.{h,cpp}``).  Ring arithmetic runs on the context's device;
metadata (levels, scales) is tracked on the host.  Ciphertexts are
immutable: every op returns a new Ciphertext.  There is no jit cache: the
ops run eagerly, and the constants each level needs are built once and
kept in ``self._plans``.

On the card the two NTT sites and the key-switch contraction launch the
hand-written kernels (``ops/cuda_ntt.py``, ``ops/cuda_switch_key.py``);
the convolution, the key-switch tail and the rescale's subtract-and-scale
are elementwise mod-q arithmetic in plain PyTorch.  Inside
``ops.ntt.plain_on_card()`` the plain PyTorch versions run on the card as
well, to check the kernels.

BFV and BGV, rotations and the rest of the evaluator surface raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import math
import sys
from typing import Dict

import torch

from .context import ContextData, SealContext
from .data import Ciphertext, RelinKeys
from .params import ParmsId, SchemeType, not_ported
from .ops import ntt as NTT
from .ops import rns as R
from .ops import u64 as U
from .ops.cuda_switch_key import switch_key_contract
from .ops.rns import _c, _cshoup, _ratio, slice_limbs, take_limbs

def _is_scale_within_bounds(scale: float, cd: ContextData) -> bool:
    """Mirrors the reference's is_scale_within_bounds (evaluator.cpp:29-48):
    scale must be a positive *normal* double below the modulus bit bound."""
    scheme = cd.parms.scheme
    scale_bit_count_bound = -1
    if scheme == SchemeType.BFV or scheme == SchemeType.BGV:
        scale_bit_count_bound = cd.parms.plain_modulus.bit_count
    elif scheme == SchemeType.CKKS:
        scale_bit_count_bound = cd.total_coeff_modulus_bit_count
    if scale <= 0 or not math.isfinite(scale) or scale < sys.float_info.min:
        return False
    return not (math.floor(math.log2(scale)) >= scale_bit_count_bound)


class _KeySwitchPlan:
    """Device constants of the CKKS key switch at one level
    (``seal_tpu/evaluator.py:541-690``), built once per level."""

    def __init__(self, context: SealContext, cd: ContextData):
        dev = cd.device
        key_cd = context.key_context_data()
        key_moduli = key_cd.coeff_modulus_values
        key_tables = key_cd.limb_tables()
        qv = cd.coeff_modulus_values
        D = len(qv)                              # decomp modulus size
        k_key = len(key_moduli)
        sel_idx = list(range(D)) + [k_key - 1]   # output limb -> key modulus
        sel_vals = [key_moduli[i] for i in sel_idx]
        self.D = D
        self.key_columns = torch.tensor(sel_idx, device=dev)
        self.sel_tables = take_limbs(key_tables, sel_idx)
        self.need_reduce = torch.tensor([[qj > qi for qi in sel_vals] for qj in qv], device=dev)
        self.last_tab = slice_limbs(key_tables, k_key - 1, k_key)
        self.dec_tab = slice_limbs(key_tables, 0, D)  # decomp moduli are key moduli[0:D]

        qk = key_moduli[-1]
        qk_half = qk >> 1
        self.qk_half = _c([qk_half], dev)
        self.qk = _c([qk], dev)
        self.qk_ratio_hi = _ratio([qk], dev)[1]
        self.dq = _c(qv, dev)
        self.dq_ratio_hi = _ratio(qv, dev)[1]
        self.qk_above = torch.tensor([[qk > qi] for qi in qv], device=dev)
        self.fix = _c([qi - (qk_half % qi) for qi in qv], dev)
        self.four_q = _c([qi << 2 for qi in qv], dev)
        self.ms_op, self.ms_qt = _cshoup(key_cd.rns_tool.inv_q_last_mod_q[:D], qv, dev)


class Evaluator:
    def __init__(self, context: SealContext):
        if not context.parameters_set:
            raise ValueError("encryption parameters are not set correctly")
        self.context = context
        self._plans: Dict[ParmsId, _KeySwitchPlan] = {}

    # ------------------------------------------------------------------
    # validation helpers
    # ------------------------------------------------------------------
    def _cd(self, ct: Ciphertext) -> ContextData:
        cd = self.context.get_context_data(ct.parms_id)
        if cd is None:
            raise ValueError("ciphertext is not valid for encryption parameters")
        if ct.size < 2:
            raise ValueError("ciphertext is empty or invalid")
        if ct.data.device != self.context.device:
            raise ValueError(f"ciphertext lies on {ct.data.device}, the context on {self.context.device}")
        return cd

    @staticmethod
    def _check_transparent(ct: Ciphertext):
        """The reference's SEAL_THROW_ON_TRANSPARENT_CIPHERTEXT default (ON);
        reads one flag back from the device."""
        if ct.is_transparent():
            raise ValueError("result ciphertext is transparent")

    # ------------------------------------------------------------------
    # multiply
    # ------------------------------------------------------------------
    def multiply(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        if ct1.parms_id != ct2.parms_id:
            raise ValueError("encrypted1 and encrypted2 parameter mismatch")
        scheme = self.context.first_context_data().parms.scheme
        if scheme != SchemeType.CKKS:
            raise not_ported(scheme)
        out = self._ckks_multiply(ct1, ct2)
        self._check_transparent(out)
        return out

    @staticmethod
    def _convolve(d1: torch.Tensor, d2: torch.Tensor, t) -> torch.Tensor:
        """Dyadic convolution out[i] = sum_{j+k=i} d1[j] * d2[k], all reduced.

        All products go through one batched ``mul_mod``; the sums are exact
        residues, so the result equals the JAX package's term-by-term loop
        (its square fast path doubles cross terms to the same residues).
        """
        s1, s2 = d1.shape[0], d2.shape[0]
        pairs = [(j, i - j) for i in range(s1 + s2 - 1)
                 for j in range(max(0, i - s2 + 1), min(i, s1 - 1) + 1)]
        js = torch.tensor([p[0] for p in pairs], device=d1.device)
        ks = torch.tensor([p[1] for p in pairs], device=d1.device)
        prods = U.mul_mod(d1.index_select(0, js), d2.index_select(0, ks), t.q, t.ratio_lo, t.ratio_hi)
        dest = [None] * (s1 + s2 - 1)
        for p, (j, k) in enumerate(pairs):
            dest[j + k] = prods[p] if dest[j + k] is None else U.add_mod(dest[j + k], prods[p], t.q)
        return torch.stack(dest)

    def _ckks_multiply(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        if not (ct1.is_ntt_form and ct2.is_ntt_form):
            raise ValueError("encrypted1 and encrypted2 must be in NTT form")
        cd = self._cd(ct1)
        self._cd(ct2)
        out = ct1.copy()
        out.data = self._convolve(ct1.data, ct2.data, cd.limb_tables())
        out.scale = ct1.scale * ct2.scale
        if not _is_scale_within_bounds(out.scale, cd):
            raise ValueError("scale out of bounds")
        return out

    # ------------------------------------------------------------------
    # key switching core (evaluator.cpp:2561-2867)
    # ------------------------------------------------------------------
    def _plan(self, cd: ContextData) -> _KeySwitchPlan:
        plan = self._plans.get(cd.parms_id)
        if plan is None:
            plan = _KeySwitchPlan(self.context, cd)
            self._plans[cd.parms_id] = plan
        return plan

    def _switch_key(self, ct: Ciphertext, target: torch.Tensor, key: dict) -> Ciphertext:
        """Returns ct with (result_c0, result_c1) added into polys 0 and 1.

        ``target`` is one RNS polynomial (D, n) in the ciphertext's domain.
        """
        cd = self._cd(ct)
        scheme = cd.parms.scheme
        if scheme in (SchemeType.CKKS, SchemeType.BGV) and not ct.is_ntt_form:
            raise ValueError(f"{scheme.name} encrypted must be in NTT form")
        if not self.context.using_keyswitching:
            raise ValueError("keyswitching is not supported by the context")
        D = len(cd.parms.coeff_modulus)
        if key is None or key["c0"].shape[0] < D:
            raise ValueError("key-switching keys are invalid for encryption parameters")
        out = ct.copy()
        out.data = self._switch_key_body(cd, ct.size, ct.data, target, key["c0"], key["c1"])
        return out

    def _switch_key_body(self, cd: ContextData, ct_size: int, ct_data: torch.Tensor,
                         target: torch.Tensor, key_c0: torch.Tensor, key_c1: torch.Tensor) -> torch.Tensor:
        scheme = cd.parms.scheme
        if scheme != SchemeType.CKKS:
            raise not_ported(scheme)
        plan = self._plan(cd)
        D = plan.D
        t_target = NTT.inverse(target, cd.limb_tables())                     # (D, n) < q

        # Select key columns (D', k_key, n) -> (D', Rn, n) and stack both
        # components: (2, D', Rn, n); the contraction uses rows [0, D).
        kc = torch.stack([key_c0.index_select(1, plan.key_columns),
                          key_c1.index_select(1, plan.key_columns)])
        prod = switch_key_contract(t_target, target, kc, plan.sel_tables, plan.need_reduce)  # (2, Rn, n) < q_i

        # Switch the special prime away and add into ct (evaluator.cpp:2806-2865).
        t_last = prod[:, D:].contiguous()                                    # (2, 1, n) NTT mod qk
        rest = prod[:, :D]                                                    # (2, D, n) NTT mod q_i
        t_last_c = NTT.inverse(t_last, plan.last_tab, lazy=True)             # < 2qk
        t_last_c = U.barrett_reduce_64(t_last_c + plan.qk_half, plan.qk, plan.qk_ratio_hi)
        red = U.barrett_reduce_64(t_last_c, plan.dq, plan.dq_ratio_hi)
        t_ntt = torch.where(plan.qk_above, red, t_last_c) + plan.fix          # < 2q_i
        t_ntt = NTT.forward(t_ntt, plan.dec_tab, lazy=True)                  # < 4q_i
        new = U.mul_mod_shoup(rest + plan.four_q - t_ntt, plan.ms_op, plan.ms_qt, plan.dq)

        out = ct_data[:ct_size].clone()
        out[:2] = U.add_mod(new, ct_data[:2], plan.dq)
        return out

    # ------------------------------------------------------------------
    # relinearize
    # ------------------------------------------------------------------
    def relinearize(self, ct: Ciphertext, relin_keys: RelinKeys, destination_size: int = 2) -> Ciphertext:
        if relin_keys.parms_id != self.context.key_parms_id:
            raise ValueError("relin_keys is not valid for encryption parameters")
        if not (2 <= destination_size <= ct.size):
            raise ValueError("destination_size must be in [2, encrypted.size()]")
        if destination_size == ct.size:
            return ct
        out = ct
        for _ in range(ct.size - destination_size):
            target = out.poly(out.size - 1)
            # key for secret power = index of the removed polynomial
            if not relin_keys.has_key(out.size - 1):
                raise ValueError("relin_keys is missing required key")
            key = relin_keys.key(out.size - 1)
            trimmed = out.copy()
            trimmed.data = out.data[: out.size - 1]
            out = self._switch_key(trimmed, target, key)
        self._check_transparent(out)
        return out

    # ------------------------------------------------------------------
    # rescaling
    # ------------------------------------------------------------------
    def _mod_switch_scale_to_next(self, ct: Ciphertext) -> Ciphertext:
        cd = self._cd(ct)
        scheme = cd.parms.scheme
        if scheme != SchemeType.CKKS:
            raise not_ported(scheme)
        if not ct.is_ntt_form:
            raise ValueError("CKKS encrypted must be in NTT form")
        next_cd = cd.next_context_data
        if next_cd is None:
            raise ValueError("end of modulus switching chain reached")
        # both the current and the destination scale must stay normal and
        # in bounds (evaluator.cpp:1232-1238)
        if not _is_scale_within_bounds(ct.scale, cd) or not _is_scale_within_bounds(
            ct.scale / cd.coeff_modulus_values[-1], next_cd
        ):
            raise ValueError("scale out of bounds")
        data = R.divide_and_round_q_last_ntt(ct.data, cd.rns_tool, cd.limb_tables())
        return Ciphertext(
            data=data,
            parms_id=next_cd.parms_id,
            is_ntt_form=True,
            scale=ct.scale / cd.coeff_modulus_values[-1],
            correction_factor=ct.correction_factor,
        )

    def rescale_to_next(self, ct: Ciphertext) -> Ciphertext:
        scheme = self.context.first_context_data().parms.scheme
        if scheme != SchemeType.CKKS:
            raise ValueError("unsupported scheme")
        out = self._mod_switch_scale_to_next(ct)
        self._check_transparent(out)
        return out
