"""Device RNS operations: base conversion, the BEHZ toolchain, the modulus
switches and table slicing.

Port of ``seal_tpu/ops/rns.py`` (the reference's ``RNSTool`` and
``BaseConverter`` ops, ``util/rns.cpp:418-1258``): the fast base
conversion ``fast_convert_array``; the BEHZ steps of the BFV multiply
(``fastbconv_m_tilde``, ``sm_mrq``, ``fast_floor``, ``fastbconv_sk``); the
modulus switches ``divide_and_round_q_last`` (BFV, coefficient form) and
``divide_and_round_q_last_ntt`` (the CKKS rescale); BFV's decryption tail
``decrypt_scale_and_round``; the constant helpers ``_c`` / ``_cshoup`` /
``_ratio``; and ``slice_limbs`` / ``take_limbs``; and BGV's three: the
exact conversion q -> {t} ``exact_convert_array`` with its decryption tail
``decrypt_modt``, and the mod-t modulus switch
``mod_t_and_divide_q_last_ntt``.  Each function mirrors the JAX package's
arithmetic step for step on int64 tensors, so the residues are the same
bits.

What reads every limb has a limb-range form for a rank of a mesh that
holds limbs [lo, hi): the conversion's partial sum over its own input
limbs (``fast_convert_array(x, conv, lo)``), which the limb group adds mod
p, and the BEHZ steps built on it; the modulus switches' ``*_limbs`` forms
take the rank's own limbs and the broadcast last limb.

The JAX package's int8 digit-plane contraction (``_convert_contraction_mxu``)
is a TPU workaround and is not ported: the conversion's contraction here is
plain and exact (:func:`_contract`).
"""

from __future__ import annotations

import copy
from typing import Sequence, Tuple

import torch

from ..ntt_tables import FourStepSlot, LimbTables, u64_tensor
from ..rns_host import HostBaseConverter, HostRNSTool, shoup_pair
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
        self.half_mod = _c([half % qi for qi in rest], device)


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


class _ModTConstants:
    """Device constants of one level's BGV modulus switch."""

    def __init__(self, tool: HostRNSTool, device):
        qv = tool.base_q.values
        rest = qv[:-1]
        t = tool.t.value
        self.t = _c([t], device)
        self.t_ratio_hi = _ratio([t], device)[1]
        self.inv_q_last_t = _cshoup([tool.inv_q_last_mod_t], [t], device) if tool.inv_q_last_mod_t != 1 else None
        self.rest_q = _c(rest, device)
        self.rest_ratio_hi = _ratio(rest, device)[1]
        self.q_last_op, self.q_last_qt = _cshoup([qv[-1] % qi for qi in rest], rest, device)
        self.inv_op, self.inv_qt = _cshoup(tool.inv_q_last_mod_q, rest, device)


def _mod_t_constants(tool: HostRNSTool, device) -> _ModTConstants:
    key = ("mod_t", str(device))
    if key not in tool.device_cache:
        tool.device_cache[key] = _ModTConstants(tool, device)
    return tool.device_cache[key]


def mod_t_and_divide_q_last_ntt(x: torch.Tensor, tool: HostRNSTool, tables: LimbTables) -> torch.Tensor:
    """BGV's modulus switch in the NTT domain (rns.cpp:1193-1237): make the
    last limb's coefficients c divisible by q_last with the correction
    delta = c + q_last ((-c q_last^-1) mod t), which is 0 mod t, then
    divide exactly.  ``x``: (..., k, n) in NTT form over base q, every
    leading poly in one call; returns (..., k-1, n) in [0, q_i)."""
    k = tool.base_q.size
    return mod_t_and_divide_q_last_ntt_limbs(x[..., : k - 1, :], x[..., k - 1:, :], 0, tool, tables)


def mod_t_and_divide_q_last_ntt_limbs(x_rest: torch.Tensor, x_last: torch.Tensor, lo: int,
                                      tool: HostRNSTool, tables: LimbTables) -> torch.Tensor:
    """Limbs [lo, lo + x_rest.shape[-2]) of the BGV modulus switch, from
    those limbs of the input and its last limb ``x_last`` (..., 1, n), as
    :func:`divide_and_round_q_last_ntt_limbs` for the rescale.  ``tables``
    covers base q."""
    k = tool.base_q.size
    hi = lo + x_rest.shape[-2]
    c = _mod_t_constants(tool, x_rest.device)
    rest_q, rest_ratio_hi = c.rest_q[lo:hi], c.rest_ratio_hi[lo:hi]

    # reduced, not lazy: c mod t must be taken of c in [0, q_last)
    c_last = NTT.inverse(x_last.contiguous(), slice_limbs(tables, k - 1, k))
    neg_c_mod_t = U.neg_mod(U.barrett_reduce_64(c_last, c.t, c.t_ratio_hi), c.t)
    if c.inv_q_last_t is not None:
        neg_c_mod_t = U.mul_mod_shoup(neg_c_mod_t, *c.inv_q_last_t, c.t)
    # delta_i = (neg_c_mod_t mod q_i) q_last + c mod q_i
    delta = U.mul_mod_shoup(U.barrett_reduce_64(neg_c_mod_t, rest_q, rest_ratio_hi), c.q_last_op[lo:hi],
                            c.q_last_qt[lo:hi], rest_q)
    delta = U.add_mod(delta, U.barrett_reduce_64(c_last, rest_q, rest_ratio_hi), rest_q)
    delta = NTT.forward(delta, slice_limbs(tables, lo, hi))
    return U.mul_mod_shoup(U.sub_mod(x_rest, delta, rest_q), c.inv_op[lo:hi], c.inv_qt[lo:hi], rest_q)


def divide_and_round_q_last(x: torch.Tensor, tool: HostRNSTool) -> torch.Tensor:
    """Coefficient-form divide-and-round by the last prime, BFV's modulus
    switch (``divide_and_round_q_last_inplace``, rns.cpp:789-829).

    ``x``: (..., k, n) over base q; returns (..., k-1, n) in [0, q_i).
    """
    k = tool.base_q.size
    return divide_and_round_q_last_limbs(x[..., :k - 1, :], x[..., k - 1:, :], 0, tool)


def divide_and_round_q_last_limbs(x_rest: torch.Tensor, x_last: torch.Tensor, lo: int,
                                  tool: HostRNSTool) -> torch.Tensor:
    """Limbs [lo, lo + x_rest.shape[-2]) of BFV's modulus switch, from those
    limbs of the coefficient-form input and its last limb ``x_last``
    (..., 1, n), as :func:`divide_and_round_q_last_ntt_limbs` for the
    rescale."""
    hi = lo + x_rest.shape[-2]
    c = _rescale_constants(tool, x_rest.device)
    rest_q = c.rest_q[lo:hi]
    last_plus = U.add_mod(x_last, c.half, c.q_last)
    temp = U.sub_mod(U.barrett_reduce_64(last_plus, rest_q, c.rest_ratio_hi[lo:hi]), c.half_mod[lo:hi], rest_q)
    diff = U.sub_mod(x_rest, temp, rest_q)
    return U.mul_mod_shoup(diff, c.inv_op[lo:hi], c.inv_qt[lo:hi], rest_q)


# ---------------------------------------------------------------------------
# Fast base conversion (rns.cpp:418-465)
# ---------------------------------------------------------------------------

_M16 = 0xFFFF
_M32 = 0xFFFFFFFF
# Input limbs summed exactly before one Barrett reduction: each product of
# two residues below 2^60 is below 2^120, so 256 of them stay below 2^128.
_SUM_WINDOW = 256


class _ConvertConstants:
    """Device constants of one converter: the input's Shoup scaling, the
    change matrix as 16-bit digits (4, k_out, k_in, 1), and the output
    moduli with their Barrett ratios.  :meth:`cut` gives those of some
    input limbs and output rows."""

    def __init__(self, conv: HostBaseConverter, device):
        ib, ob = conv.ibase, conv.obase
        self.inv_op, self.inv_qt = _cshoup(conv.inv_punct, ib.values, device)
        self.iq = _c(ib.values, device)
        self.digits = torch.tensor([[[[(m >> (16 * b)) & _M16] for m in row] for row in conv.matrix]
                                    for b in range(4)], dtype=torch.int64, device=device)
        self.oq = _c(ob.values, device)
        self.oratio_lo, self.oratio_hi = _ratio(ob.values, device)
        self.iratio_lo = _c(conv.iratio_lo, device)
        self.iratio_hi = _c(conv.iratio_hi, device)
        self.q_mod_o0 = _cshoup([conv.q_mod_obase0], ob.values[:1], device)

    def cut(self, lo: int, hi: int, rows) -> "_ConvertConstants":
        """The constants of input limbs [lo, hi) and of the output rows
        ``rows`` (a tuple of indices, or None for every row)."""
        out = copy.copy(self)
        out.inv_op, out.inv_qt, out.iq = self.inv_op[lo:hi], self.inv_qt[lo:hi], self.iq[lo:hi]
        out.digits = self.digits[:, :, lo:hi]
        if rows is not None:
            index = torch.tensor(rows, device=self.oq.device)
            out.digits = out.digits.index_select(1, index)
            out.oq, out.oratio_lo, out.oratio_hi = (a.index_select(0, index)
                                                    for a in (self.oq, self.oratio_lo, self.oratio_hi))
        return out


def _convert_constants(conv: HostBaseConverter, device, lo: int = 0, hi: int = None,
                       rows=None) -> _ConvertConstants:
    """The converter's constants on ``device``, cut to input limbs [lo, hi)
    and output rows ``rows`` where they are given; built once each."""
    whole_key = ("convert", str(device))
    if whole_key not in conv.device_cache:
        conv.device_cache[whole_key] = _ConvertConstants(conv, device)
    hi = conv.ibase.size if hi is None else hi
    if (lo, hi, rows) == (0, conv.ibase.size, None):
        return conv.device_cache[whole_key]
    key = whole_key + (lo, hi, rows)
    if key not in conv.device_cache:
        conv.device_cache[key] = conv.device_cache[whole_key].cut(lo, hi, rows)
    return conv.device_cache[key]


def _contract(temp: torch.Tensor, c: _ConvertConstants) -> torch.Tensor:
    """sum_i temp[..., i, :] * matrix[j, i] mod p_j, exact: (..., k_in, n)
    residues below 2^60 -> (..., k_out, n) in [0, p_j).

    Each input residue is split into 32-bit words x_a and each matrix entry
    into 16-bit digits m_b; a product x_a * m_b is below 2^48, so a sum over
    at most 256 input limbs is below 2^56 and exact in int64.  The six
    partial sums (one per 16-bit offset) carry into the u128 value of the
    whole sum, which one Barrett reduction takes mod p_j: the same residue
    as the JAX package's u128 accumulation with its guard every 64
    summands.  The sums run over all input limbs at once (one broadcast
    product and one sum per word), so the launches do not grow with k_in;
    wider inputs (k_in > 256) add their windows' residues mod p_j.
    """
    k_in = temp.shape[-2]
    out = None
    for lo in range(0, k_in, _SUM_WINDOW):
        part = temp[..., None, None, lo:lo + _SUM_WINDOW, :]              # (..., 1, 1, w, n)
        digits = c.digits[:, :, lo:lo + _SUM_WINDOW]                         # (4, k_out, w, 1)
        p_lo = (digits * (part & _M32)).sum(-2)                              # (..., 4, k_out, n) < 2^56
        p_hi = (digits * (part >> 32)).sum(-2)
        # p[s] is the sum at bit offset 16 s
        p = [p_lo[..., 0, :, :], p_lo[..., 1, :, :], p_lo[..., 2, :, :] + p_hi[..., 0, :, :],
             p_lo[..., 3, :, :] + p_hi[..., 1, :, :], p_hi[..., 2, :, :], p_hi[..., 3, :, :]]
        words = [p[0] + ((p[1] & _M16) << 16),
                 p[2] + ((p[3] & _M16) << 16) + (p[1] >> 16),
                 p[4] + ((p[5] & _M16) << 16) + (p[3] >> 16),
                 p[5] >> 16]
        for w in range(3):
            words[w + 1] = words[w + 1] + (words[w] >> 32)
            words[w] = words[w] & _M32
        acc = (U._join(words[0], words[1]), U._join(words[2], words[3]))
        red = U.barrett_reduce_128(acc, c.oq, c.oratio_lo, c.oratio_hi)
        out = red if out is None else U.add_mod(out, red, c.oq)
    return out


def fast_convert_array(x: torch.Tensor, conv: HostBaseConverter, lo: int = 0, rows=None) -> torch.Tensor:
    """Fast base conversion: (..., k_in, n) over the converter's input base
    -> (..., k_out, n) over its output base (rns.cpp:418-465): scale by the
    (prescaled) inverse punctured products, then the exact contraction with
    the change matrix.

    The partial form, for a rank of a mesh: ``x`` holds input limbs [lo,
    lo + x.shape[-2]) only, and each output is the sum over those limbs
    reduced to [0, p_j).  Each output of the whole conversion is
    sum_i ([x_i q~_i]_{q_i} q_i* mod p_j) mod p_j, so the ranks' partials
    added mod p_j (``parallel/shard_ops.gather_add_mod``) give its residue.
    ``rows`` (a tuple of output indices) computes those outputs alone, in
    that order."""
    hi = lo + x.shape[-2]
    c = _convert_constants(conv, x.device, lo, hi, rows)
    if hi == lo:
        return x.new_zeros(x.shape[:-2] + (c.oq.shape[0], x.shape[-1]))
    return _contract(U.mul_mod_shoup(x, c.inv_op, c.inv_qt, c.iq), c)


def convert_moduli(conv: HostBaseConverter, device) -> torch.Tensor:
    """The converter's output moduli as a (k_out, 1) tensor on ``device``:
    what a limb group adds the partial sums of :func:`fast_convert_array`
    mod."""
    return _convert_constants(conv, device).oq


def exact_convert_array(x: torch.Tensor, conv: HostBaseConverter) -> torch.Tensor:
    """Exact (rounded) conversion to a one-modulus output base {t}
    (``BaseConverter::exact_convert_array``, rns.cpp:466-541), in the JAX
    package's 64-bit fixed point: with temp_i = x_i (Q/q_i)^-1 mod q_i, the
    fraction temp_i / q_i is (mulhi64(temp_i, iratio_lo) + mullo64(temp_i,
    iratio_hi)) mod 2^64; the fractions and 1/2 are summed mod 2^64, and the
    carries out of the sum count v = round(sum temp_i / q_i).  The result is
    (sum_i temp_i (Q/q_i)) mod t - v (Q mod t).  ``x``: (..., k_in, n);
    returns (..., 1, n) in [0, t)."""
    if conv.obase.size != 1:
        raise ValueError("exact_convert_array requires obase of size 1")
    c = _convert_constants(conv, x.device)
    temp = U.mul_mod_shoup(x, c.inv_op, c.inv_qt, c.iq)
    frac = U.add64(U.mulhi64(temp, c.iratio_lo), U.mullo64(temp, c.iratio_hi))
    acc = torch.zeros_like(temp[..., :1, :])
    carries = torch.zeros_like(acc)
    for i in range(temp.shape[-2]):
        acc, carry = U.add64_carry(acc, frac[..., i:i + 1, :])
        carries = carries + carry
    _, carry = U.add64_carry(acc, torch.full_like(acc, -(1 << 63)))     # + 1/2: bit 63
    v_q_mod_t = U.mul_mod_shoup(carries + carry, *c.q_mod_o0, c.oq)
    return U.sub_mod(_contract(temp, c), v_q_mod_t, c.oq)


def decrypt_modt(x: torch.Tensor, tool: HostRNSTool) -> torch.Tensor:
    """BGV's decryption tail: the exact conversion q -> {t} of the phase's
    coefficients (..., k, n); returns (..., 1, n) in [0, t)."""
    return exact_convert_array(x, tool.conv_q_to_t)


# ---------------------------------------------------------------------------
# The BEHZ toolchain of the BFV multiply (rns.cpp:903-1131)
# ---------------------------------------------------------------------------

class _BEHZConstants:
    """Device constants of one level's BEHZ steps and BFV decryption."""

    def __init__(self, tool: HostRNSTool, device):
        qv = tool.base_q.values
        bskv = tool.base_Bsk.values
        mt = tool.m_tilde.value
        msk = tool.m_sk.value
        self.q = _c(qv, device)
        self.bsk = _c(bskv, device)
        self.m_tilde = _c([mt], device)
        self.m_tilde_half = _c([mt >> 1], device)
        self.m_tilde_corr = _c([q - mt for q in bskv], device)
        self.neg_inv_q_mt = _cshoup([tool.neg_inv_prod_q_mod_m_tilde], [mt], device)
        self.prod_q_bsk = _cshoup(tool.prod_q_mod_Bsk, bskv, device)
        self.inv_mt_bsk = _cshoup(tool.inv_m_tilde_mod_Bsk, bskv, device)
        self.inv_q_bsk = _cshoup(tool.inv_prod_q_mod_Bsk, bskv, device)
        self.m_sk = _c([msk], device)
        self.m_sk_half_up = _c([(msk >> 1) + 1], device)
        self.inv_B_msk = _cshoup([tool.inv_prod_B_mod_m_sk], [msk], device)
        self.prod_B_q = _cshoup(tool.prod_B_mod_q, qv, device)
        self.neg_prod_B_q = _cshoup([(qi - p) % qi for p, qi in zip(tool.prod_B_mod_q, qv)], qv, device)
        if tool.base_t_gamma is not None:
            t, gamma = tool.t.value, tool.gamma.value
            self.prod_t_gamma_q = _cshoup(tool.prod_t_gamma_mod_q, qv, device)
            self.t_gamma = _c([t, gamma], device)
            self.neg_inv_q_t_gamma = _cshoup(tool.neg_inv_q_mod_t_gamma, [t, gamma], device)
            self.t = _c([t], device)
            self.t_ratio_hi = _ratio([t], device)[1]
            self.gamma = _c([gamma], device)
            self.gamma_half_up = _c([(gamma >> 1) + 1], device)
            self.inv_gamma_t = _cshoup([tool.inv_gamma_mod_t], [t], device)


def _behz_constants(tool: HostRNSTool, device) -> _BEHZConstants:
    key = ("behz", str(device))
    if key not in tool.device_cache:
        tool.device_cache[key] = _BEHZConstants(tool, device)
    return tool.device_cache[key]


def fastbconv_m_tilde(x: torch.Tensor, tool: HostRNSTool, lo: int = 0) -> torch.Tensor:
    """q -> Bsk U {m_tilde} of x * m_tilde (rns.cpp:1086-1131): one
    conversion through the merged, m_tilde-prescaled converter, whose
    m_tilde pre-scale is per limb.  With ``lo``, the partial sum over the q
    limbs [lo, ...) that ``x`` holds (:func:`fast_convert_array`)."""
    return fast_convert_array(x, tool.conv_q_to_Bsk_m_tilde_scaled, lo)


def sm_mrq(x: torch.Tensor, tool: HostRNSTool) -> torch.Tensor:
    """Small Montgomery reduction mod q, Bsk U {m_tilde} -> Bsk (rns.cpp:979):
    (x + q * r_m_tilde) * m_tilde^-1 mod Bsk, with r_m_tilde =
    -x * q^-1 mod m_tilde centered (r >= m_tilde / 2 counts as r - m_tilde)."""
    c = _behz_constants(tool, x.device)
    k_bsk = tool.base_Bsk.size
    r = U.mul_mod_shoup(x[..., k_bsk:, :], *c.neg_inv_q_mt, c.m_tilde)
    centered = torch.where(r >= c.m_tilde_half, r + c.m_tilde_corr, r)
    # the Shoup product is exact for any 64-bit multiplicand
    inner = U.add_mod(U.mul_mod_shoup(centered, *c.prod_q_bsk, c.bsk), x[..., :k_bsk, :], c.bsk)
    return U.mul_mod_shoup(inner, *c.inv_mt_bsk, c.bsk)


def fast_floor(x: torch.Tensor, tool: HostRNSTool) -> torch.Tensor:
    """floor(x / q), q U Bsk -> Bsk (rns.cpp:1041-1085): ``x`` (..., k + k_bsk, n)
    holds the q limbs first."""
    k = tool.base_q.size
    return fast_floor_finish(x[..., k:, :], fast_convert_array(x[..., :k, :], tool.conv_q_to_Bsk), tool)


def fast_floor_finish(x_bsk: torch.Tensor, dest: torch.Tensor, tool: HostRNSTool) -> torch.Tensor:
    """The floor's tail, per Bsk limb: (x_bsk + q - dest) q^-1 mod Bsk, with
    ``dest`` the conversion q -> Bsk (``tool.conv_q_to_Bsk``) of all the q
    limbs: on a mesh, the ranks' partial conversions added mod Bsk."""
    c = _behz_constants(tool, x_bsk.device)
    # the lazy difference is fine for Shoup
    return U.mul_mod_shoup(x_bsk + c.bsk - dest, *c.inv_q_bsk, c.bsk)


def fastbconv_sk(x: torch.Tensor, tool: HostRNSTool, lo: int = 0, hi: int = None) -> torch.Tensor:
    """Shenoy-Kumaresan conversion Bsk -> q (rns.cpp:903-978); the two
    conversions (B -> q and B -> m_sk) run as one to q U {m_sk}.  ``x``
    holds the whole Bsk part; the output is q limbs [lo, hi), all of them
    by default, which is what a rank of a mesh writes."""
    c = _behz_constants(tool, x.device)
    k_B = tool.base_B.size
    k = tool.base_q.size
    hi = k if hi is None else hi
    rows = None if (lo, hi) == (0, k) else (*range(lo, hi), k)
    both = fast_convert_array(x[..., :k_B, :], tool.conv_B_to_q_m_sk, rows=rows)
    m = hi - lo
    dest = both[..., :m, :]
    q = c.q[lo:hi]
    # alpha = (temp + (m_sk - x_sk)) * B^-1 mod m_sk
    alpha = U.mul_mod_shoup(both[..., m:, :] + c.m_sk - x[..., k_B:, :], *c.inv_B_msk, c.m_sk)
    branch_hi = U.add_mod(U.mul_mod_shoup(U.neg_mod(alpha, c.m_sk), c.prod_B_q[0][lo:hi], c.prod_B_q[1][lo:hi], q),
                          dest, q)
    branch_lo = U.add_mod(U.mul_mod_shoup(alpha, c.neg_prod_B_q[0][lo:hi], c.neg_prod_B_q[1][lo:hi], q), dest, q)
    return torch.where(alpha >= c.m_sk_half_up, branch_hi, branch_lo)


def decrypt_scale_and_round(x: torch.Tensor, tool: HostRNSTool) -> torch.Tensor:
    """BFV's decryption tail (rns.cpp:1133-1192): round(t/q * x) mod t
    through the {t, gamma} base.  ``x``: (..., k, n) phase over q; returns
    (..., 1, n) in [0, t)."""
    c = _behz_constants(tool, x.device)
    temp = U.mul_mod_shoup(x, *c.prod_t_gamma_q, c.q)
    tg = U.mul_mod_shoup(fast_convert_array(temp, tool.conv_q_to_t_gamma), *c.neg_inv_q_t_gamma, c.t_gamma)
    t_part, g_part = tg[..., 0:1, :], tg[..., 1:2, :]
    add_result = U.add_mod(t_part, U.barrett_reduce_64(c.gamma - g_part, c.t, c.t_ratio_hi), c.t)
    sub_result = U.sub_mod(t_part, U.barrett_reduce_64(g_part, c.t, c.t_ratio_hi), c.t)
    out = torch.where(g_part >= c.gamma_half_up, add_result, sub_result)
    return U.mul_mod_shoup(out, *c.inv_gamma_t, c.t)


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
