"""The ring bodies of the server ops, on local tensors.

The dyadic convolution of ``multiply``, the two halves of the key switch
(the contraction over decomposition limbs, and the tail that switches the
special prime away) and the Galois body of ``apply_galois`` built from
them, with the per-level device constants they read
(:class:`KeySwitchPlan`).  Each body takes (..., size, k, n) data on one
device; the limb range [lo, hi) it is given lets a rank of a mesh run it on
its own limbs.  ``evaluator.py`` runs them on whole ciphertexts, the mesh
bodies (``parallel/sharded.py``) on every rank's shard.  The key switch
serves CKKS and BGV on NTT-form data and BFV on coefficient-form data; the
plan carries the scheme's branch (``seal_tpu/evaluator.py:553-557,
641-698``): BGV's tail makes the special prime's share divisible by it
with a correction that is 0 mod t, where CKKS and BFV round.  The BFV
multiply's BEHZ body is ``bfv_bodies.py``.

On the card the NTT sites and the contraction launch the hand-written
kernels (``ops/cuda_ntt.py``, ``ops/cuda_switch_key.py``); the Galois
permutation is one ``index_select``, and the rest is elementwise mod-q
arithmetic in plain PyTorch.
"""

from __future__ import annotations

import torch

from . import debug
from .context import ContextData, SealContext
from .ntt_tables import LimbTables
from .params import SchemeType
from .ops import ntt as NTT
from .ops import poly as P
from .ops import u64 as U
from .ops.cuda_switch_key import switch_key_contract
from .ops.rns import _c, _cshoup, _ratio, slice_limbs, take_limbs


class KeySwitchPlan:
    """Device constants of the key switch at one level
    (``seal_tpu/evaluator.py:541-698``), built once per level and device.
    ``ntt_form`` is the scheme's branch: CKKS and BGV switch NTT-form polys,
    BFV coefficient-form ones; ``bgv`` holds BGV's tail constants (None for
    the other schemes).

    A rank of a mesh that holds limbs [lo, hi) of the level reads the rows
    [lo, hi) of the per-limb constants and the bundles of :meth:`level` and
    :meth:`dec`.
    """

    def __init__(self, context: SealContext, cd: ContextData, device=None):
        dev = cd.device if device is None else torch.device(device)
        key_cd = context.key_context_data()
        key_moduli = key_cd.coeff_modulus_values
        key_tables = key_cd.limb_tables(dev)
        qv = cd.coeff_modulus_values
        D = len(qv)                              # decomp modulus size
        k_key = len(key_moduli)
        sel_idx = list(range(D)) + [k_key - 1]   # output limb -> key modulus
        sel_vals = [key_moduli[i] for i in sel_idx]
        self.D = D
        self.ntt_form = cd.parms.scheme in (SchemeType.CKKS, SchemeType.BGV)
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
        # the tail's lazy offset: the key-switched sum lies below 4q_i after
        # the CKKS forward NTT, below 2q_i after the BFV inverse NTT
        self.lazy_q = _c([qi << (2 if self.ntt_form else 1) for qi in qv], dev)
        self.ms_op, self.ms_qt = _cshoup(key_cd.rns_tool.inv_q_last_mod_q[:D], qv, dev)
        self.bgv = _BGVTail(key_cd, qk, qv, dev) if cd.parms.scheme == SchemeType.BGV else None
        self.level_tab = cd.limb_tables(dev)
        self._cut = {}

    def _cut_tables(self, which: str, whole: LimbTables, lo: int, hi: int) -> LimbTables:
        if (lo, hi) == (0, self.D):
            return whole
        cut = self._cut.get((which, lo, hi))
        if cut is None:
            cut = self._cut[(which, lo, hi)] = slice_limbs(whole, lo, hi)
        return cut

    def level(self, lo: int, hi: int) -> LimbTables:
        """The level's tables for limbs [lo, hi)."""
        return self._cut_tables("level", self.level_tab, lo, hi)

    def dec(self, lo: int, hi: int) -> LimbTables:
        """The key level's tables for decomposition limbs [lo, hi)."""
        return self._cut_tables("dec", self.dec_tab, lo, hi)


class _BGVTail:
    """The constants of BGV's key-switch tail (``seal_tpu/evaluator.py:641-662``):
    t with its Barrett ratio, the KEY level's q_k^-1 mod t as a Shoup pair
    (None when it is 1), and q_k mod q_i as Shoup pairs."""

    def __init__(self, key_cd: ContextData, qk: int, qv, dev):
        tv = key_cd.parms.plain_modulus.value
        inv_qk_t = key_cd.rns_tool.inv_q_last_mod_t
        self.t = _c([tv], dev)
        self.t_ratio_hi = _ratio([tv], dev)[1]
        self.inv_qk_t = _cshoup([inv_qk_t], [tv], dev) if inv_qk_t != 1 else None
        self.qk_op, self.qk_qt = _cshoup([qk % qi for qi in qv], qv, dev)


def convolve(d1: torch.Tensor, d2: torch.Tensor, t) -> torch.Tensor:
    """Dyadic convolution out[i] = sum_{j+k=i} d1[j] * d2[k], all reduced,
    over the polynomial axis -3 of (..., size, k, n) data.

    All products go through one batched ``mul_mod``; the sums are exact
    residues, so the result equals the JAX package's term-by-term loop
    (its square fast path doubles cross terms to the same residues).
    """
    s1, s2 = d1.shape[-3], d2.shape[-3]
    pairs = [(j, i - j) for i in range(s1 + s2 - 1)
             for j in range(max(0, i - s2 + 1), min(i, s1 - 1) + 1)]
    js = torch.tensor([p[0] for p in pairs], device=d1.device)
    ks = torch.tensor([p[1] for p in pairs], device=d1.device)
    prods = U.mul_mod(d1.index_select(-3, js), d2.index_select(-3, ks), t.q, t.ratio_lo, t.ratio_hi)
    dest = [None] * (s1 + s2 - 1)
    for p, (j, k) in enumerate(pairs):
        term = prods.select(-3, p)
        dest[j + k] = term if dest[j + k] is None else U.add_mod(dest[j + k], term, t.q)
    return torch.stack(dest, dim=-3)


def key_switch_contract(plan: KeySwitchPlan, target: torch.Tensor, key_c0: torch.Tensor,
                        key_c1: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """The key-switch sum over decomposition limbs [lo, hi): ``target``
    (..., hi - lo, n) holds those limbs in the scheme's form (NTT for CKKS,
    coefficients for BFV), ``key_c0``/``key_c1`` their key rows
    (hi - lo, k_key, n).  Returns (..., 2, Rn, n) < q_i.  A CKKS target is
    inverse-transformed first and its NTT form gives the diagonal; a BFV
    target goes in as it is, with no diagonal."""
    target = target.contiguous()
    if plan.ntt_form:
        t_target, t_diag = NTT.inverse(target, plan.level(lo, hi)), target              # (..., D, n) < q
    else:
        t_target, t_diag = target, None
    if debug.enabled():
        _check_contract(plan, t_target, t_diag, lo, hi)

    # Select key columns (D', k_key, n) -> (D', Rn, n) and stack both
    # components: (2, D', Rn, n); the contraction uses rows [0, hi - lo).
    kc = torch.stack([key_c0.index_select(1, plan.key_columns),
                      key_c1.index_select(1, plan.key_columns)])
    return switch_key_contract(t_target, t_diag, kc, plan.sel_tables,
                               plan.need_reduce[lo:hi], row_offset=lo)


def _check_contract(plan: KeySwitchPlan, t_target: torch.Tensor, t_diag, lo: int, hi: int) -> None:
    """SEAL_TPU_DEBUG's contract of the contraction
    (``seal_tpu/evaluator.py:606-615``): 64 lazy summands of 4q * q must
    stay below 2^128 for the largest modulus in play (the Barrett guard
    every 64 summands, ``util/defines.h:66``), and the target below 4q."""
    max_q = max(plan.sel_tables.moduli_values)
    if min(64, plan.D) * (4 * max_q) * max_q >= 1 << 128:
        raise debug.RangeError(f"switch_key accumulator would overflow u128; D={plan.D} "
                               f"max_q bits={max_q.bit_length()}")
    four_q = 2 * plan.level(lo, hi).two_q
    for x in (t_target, t_diag):
        if x is not None:
            debug.check_below(x, four_q, "switch_key target < 4q before the 128-bit accumulation")


def key_switch_tail(plan: KeySwitchPlan, prod: torch.Tensor, ct_data: torch.Tensor,
                    lo: int, hi: int) -> torch.Tensor:
    """Switch the special prime away and add into the ciphertext
    (evaluator.cpp:2806-2865), on limbs [lo, hi), in the scheme's form:
    CKKS and BGV bring their correction term into the NTT domain, BFV takes
    the sum out of it.  ``prod`` is the whole sum (..., 2, Rn, n),
    ``ct_data`` (..., size, hi - lo, n) those limbs of the ciphertext.  With size 1 the ciphertext's c1 is zero, as after
    a Galois permutation whose c1 was switched away: the output's c1 is
    the switched pair's alone."""
    D = plan.D
    dq = plan.dq[lo:hi]
    t_last = prod[..., D:, :].contiguous()                              # (..., 2, 1, n) NTT mod qk
    rest = prod[..., lo:hi, :]                                           # (..., 2, hi-lo, n) NTT mod q_i
    if plan.bgv is not None:
        new = _bgv_tail(plan, t_last, rest, lo, hi)
    else:
        new = _rounding_tail(plan, t_last, rest, lo, hi)
    if ct_data.shape[-3] == 1:
        return torch.cat([U.add_mod(new[..., :1, :, :], ct_data, dq), new[..., 1:, :, :]], dim=-3)
    out = ct_data.clone()
    out[..., :2, :, :] = U.add_mod(new, ct_data[..., :2, :, :], dq)
    return out


def _rounding_tail(plan: KeySwitchPlan, t_last: torch.Tensor, rest: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """CKKS's and BFV's (evaluator.cpp:2806-2865): subtract the special
    prime's share rounded, times q_k^-1 mod q_i; (..., 2, hi - lo, n)."""
    dq = plan.dq[lo:hi]
    t_last_c = NTT.inverse(t_last, plan.last_tab, lazy=True)            # < 2qk
    t_last_c = U.barrett_reduce_64(t_last_c + plan.qk_half, plan.qk, plan.qk_ratio_hi)
    red = U.barrett_reduce_64(t_last_c, dq, plan.dq_ratio_hi[lo:hi])
    t_ntt = torch.where(plan.qk_above[lo:hi], red, t_last_c) + plan.fix[lo:hi]  # < 2q_i
    if plan.ntt_form:
        t_ntt = NTT.forward(t_ntt, plan.dec(lo, hi), lazy=True)         # < 4q_i
    else:
        rest = NTT.inverse(rest.contiguous(), plan.dec(lo, hi), lazy=True)   # < 2q_i
    return U.mul_mod_shoup(rest + plan.lazy_q[lo:hi] - t_ntt, plan.ms_op[lo:hi], plan.ms_qt[lo:hi], dq)


def _bgv_tail(plan: KeySwitchPlan, t_last: torch.Tensor, rest: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """BGV's (``seal_tpu/evaluator.py:641-662``): with c the special prime's
    share in [0, q_k), subtract delta = c + q_k ((-c q_k^-1) mod t), which
    is 0 mod t and c mod q_k, then multiply by q_k^-1 mod q_i;
    (..., 2, hi - lo, n)."""
    b = plan.bgv
    dq, ratio_hi = plan.dq[lo:hi], plan.dq_ratio_hi[lo:hi]
    # reduced, not lazy: c mod t must be taken of c in [0, q_k)
    c = NTT.inverse(t_last, plan.last_tab)
    kk = U.neg_mod(U.barrett_reduce_64(c, b.t, b.t_ratio_hi), b.t)
    if b.inv_qk_t is not None:
        kk = U.mul_mod_shoup(kk, *b.inv_qk_t, b.t)
    delta = U.mul_mod_shoup(U.barrett_reduce_64(kk, dq, ratio_hi), b.qk_op[lo:hi], b.qk_qt[lo:hi], dq)
    delta = NTT.forward(U.add_mod(delta, U.barrett_reduce_64(c, dq, ratio_hi), dq), plan.dec(lo, hi))
    return U.mul_mod_shoup(U.sub_mod(rest, delta, dq), plan.ms_op[lo:hi], plan.ms_qt[lo:hi], dq)


def galois(plan: KeySwitchPlan, data: torch.Tensor, tables, key_c0: torch.Tensor,
           key_c1: torch.Tensor) -> torch.Tensor:
    """The Galois automorphism of (..., 2, k, n) data and the key switch of
    its permuted c1 (evaluator.cpp:2384-2470): both polys are permuted by
    one gather with the element's index tensor on the data's device, the
    NTT-domain ``(table,)`` for CKKS and BGV or the coefficient ``(source,
    negate)`` pair for BFV (``GaloisTool.ntt_index`` / ``coeff_index``), the key
    switch contracts the permuted c1 with the key's first D rows, and the
    tail adds the result into (permuted c0, 0).  With a leading batch axis
    kernel B takes the batch on its grid, one launch for all of it."""
    D = plan.D
    if plan.ntt_form:
        perm = P.apply_galois_ntt(data, *tables)
    else:
        perm = P.apply_galois_coeff(data, *tables, plan.level(0, D).q)
    prod = key_switch_contract(plan, perm[..., 1, :, :], key_c0[:D], key_c1[:D], 0, D)
    return key_switch_tail(plan, prod, perm[..., :1, :, :], 0, D)
