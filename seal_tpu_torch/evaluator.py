"""Evaluator: the BFV, CKKS and BGV homomorphic op surface.

Port of ``seal_tpu/evaluator.py`` (counterpart of ``evaluator.{h,cpp}``):
negate, add, sub, add_many (BGV balancing the operands' correction
factors), multiply, square, multiply_many and exponentiate (BFV and BGV),
relinearize, the modulus switches (mod_switch_to_next/to: BFV's
divide-and-round, BGV's mod-t switch, CKKS's limb drop; rescale_to_next/to,
mod_reduce_to_next/to, mod_switch_plain_to), the plaintext ops (add_plain,
sub_plain: BFV's scaling variant, BGV's lift of the plaintext times the
correction factor; multiply_plain on all four of its branches), the NTT
transforms, and the Galois ops (apply_galois on either form,
rotate_rows/rotate_columns for BFV and BGV, rotate_vector/complex_conjugate
for CKKS).  Ring arithmetic runs on the context's device; metadata (levels,
scales, BGV correction factors) is tracked on the host.
Ciphertexts are immutable: every op returns a new Ciphertext.  There is no
jit cache: the ops run eagerly, and the constants each level needs are
built once and kept in ``self._plans``.

The ring bodies live in ``ckks_bodies.py`` (the convolution, the key
switch of either form with its CKKS, BFV and BGV tails, the Galois body)
and ``bfv_bodies.py`` (the BEHZ multiply), their mesh versions, for all
three schemes, in ``parallel/sharded.py``.  On the card
every NTT and the key-switch contraction launch the hand-written kernels
(``ops/cuda_ntt.py``, ``ops/cuda_switch_key.py``); the Galois permutation
is one ``index_select``, and the rest is elementwise mod-q arithmetic in
plain PyTorch.  Inside ``ops.ntt.plain_on_card()`` the plain PyTorch
versions run on the card as well, to check the kernels.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, Sequence

import numpy as np
import torch

from . import bfv_bodies, numth
from .ckks_bodies import KeySwitchPlan, convolve, galois, key_switch_contract, key_switch_tail
from .context import ContextData, SealContext
from .data import Ciphertext, GaloisKeys, KSwitchKeys, Plaintext, RelinKeys
from .encryptor import bgv_lift_plain, scaling_variant_term
from .params import ParmsId, SchemeType
from .parallel import sharded
from .parallel.mesh import ShardedTensor, shard, shard_kswitch_key
from .ops import ntt as NTT
from .ops import poly as P
from .ops import rns as R
from .ops import u64 as U
from .ops.rns import _c, _cshoup

# The reference's SEAL_THROW_ON_TRANSPARENT_CIPHERTEXT build option (ON);
# an evaluator checks its results only while this and its own flag are set.
THROW_ON_TRANSPARENT = True


def are_same_scale(scale1: float, scale2: float) -> bool:
    """Reference semantics (``util::are_close``, common.h:574-578 via
    ``are_same_scale``, evaluator.cpp:23-27): machine-epsilon-relative
    closeness."""
    scale_factor = max(abs(scale1), abs(scale2), 1.0)
    return abs(scale1 - scale2) < sys.float_info.epsilon * scale_factor


def add_sub_padded(x: torch.Tensor, y: torch.Tensor, q: torch.Tensor, is_add: bool) -> torch.Tensor:
    """(x +- y) mod q over the polynomial axis -3 of (..., size, k, n) data;
    the shorter operand's missing polys are zero."""
    pad = x.shape[-3] - y.shape[-3]
    if pad:
        zeros = lambda a, p: a.new_zeros(a.shape[:-3] + (p,) + a.shape[-2:])
        x, y = (x, torch.cat([y, zeros(y, pad)], dim=-3)) if pad > 0 else (torch.cat([x, zeros(x, -pad)], dim=-3), y)
    return U.add_mod(x, y, q) if is_add else U.sub_mod(x, y, q)


def _balance_correction_factors(factor1: int, factor2: int, t: int):
    """BGV correction-factor balancing via extended Euclid minimizing the
    lifted |e1| + |e2| (evaluator.cpp:56-118).  Returns (f, e1, e2)."""
    half_t = t // 2

    def sum_abs(x, y):
        xb = x - t if x > half_t else x
        yb = y - t if y > half_t else y
        return abs(xb) + abs(yb)

    ratio = numth.invert_mod(factor1, t) * factor2 % t
    e1, e2 = ratio, 1
    best = sum_abs(e1, e2)

    prev_a, a = t, ratio
    prev_b, b = 0, 1
    while a != 0:
        q = prev_a // a
        prev_a, a = a, prev_a - q * a
        prev_b, b = b, prev_b - q * b
        a_mod = a % t
        b_mod = b % t
        if a_mod != 0 and numth.gcd(a_mod, t) == 1:
            new_sum = sum_abs(a_mod, b_mod)
            if new_sum < best:
                best = new_sum
                e1, e2 = a_mod, b_mod
    return e1 * factor1 % t, e1, e2


def add_sub_body(cd: ContextData, factor1: int, factor2: int, is_add: bool):
    """(correction factor, fn(x, y, t)) of add or sub on operands with
    correction factors ``factor1`` and ``factor2``, ``t`` the tables of the
    data's limbs: BGV operands whose factors differ are first multiplied by
    the balancing e1 and e2 mod q_i (evaluator.cpp:197-216), so both carry
    the factor returned."""
    if cd.parms.scheme != SchemeType.BGV or factor1 == factor2:
        return factor1, lambda x, y, t: add_sub_padded(x, y, t.q, is_add)
    f, e1, e2 = _balance_correction_factors(factor1, factor2, cd.parms.plain_modulus.value)

    def balanced(x, y, t):
        qv = t.moduli_values
        times = lambda d, e: U.mul_mod_shoup(d, *_cshoup([e % qi for qi in qv], qv, d.device), t.q)
        return add_sub_padded(times(x, e1), times(y, e2), t.q, is_add)

    return f, balanced


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


class Evaluator:
    def __init__(self, context: SealContext, throw_on_transparent: bool = True, mesh=None):
        """``throw_on_transparent`` mirrors the reference's
        SEAL_THROW_ON_TRANSPARENT_CIPHERTEXT option (default ON).  The check
        reads one flag back from the device after every op, which waits for
        the op, so latency-critical pipelines may turn it off.

        ``mesh`` (an ``HEMesh``, ``parallel/mesh.py``) makes the evaluator
        mesh-aware for all three schemes: ciphertexts and keys placed with
        :meth:`shard` and :meth:`shard_keys` have their RNS limbs split over
        the mesh's limb axis, and the ops then run on every rank's limbs,
        with the key-switch sum, BFV's base-conversion sums and the last
        limb of a modulus switch exchanged between the ranks
        (``parallel/sharded.py``).  Without a mesh, or on tensors that
        are not sharded, the ops run on one device; both give the same bits.
        """
        if not context.parameters_set:
            raise ValueError("encryption parameters are not set correctly")
        self.context = context
        self.throw_on_transparent = throw_on_transparent
        self.hem = mesh
        self._plans: Dict[tuple, KeySwitchPlan] = {}

    # ------------------------------------------------------------------
    # mesh placement (no-ops without a mesh)
    # ------------------------------------------------------------------
    def shard(self, ct: Ciphertext) -> Ciphertext:
        """Place a ciphertext's RNS limbs over the mesh's limb axis."""
        if self.hem is None:
            return ct
        out = ct.copy()
        out.data = shard(self.hem.mesh, ct.data, self.hem.ct_spec())
        return out

    def shard_keys(self, keys: KSwitchKeys) -> KSwitchKeys:
        """Place key-switch keys (decomposition axis) over the mesh's limb
        axis, or on every rank with ``replicate_keys``, once, ahead of the
        op stream."""
        if self.hem is None:
            return keys
        out = type(keys)()
        out.parms_id = keys.parms_id
        out.keys = [None if entry is None else shard_kswitch_key(self.hem, entry) for entry in keys.keys]
        return out

    # ------------------------------------------------------------------
    # validation helpers
    # ------------------------------------------------------------------
    def _cd(self, ct: Ciphertext) -> ContextData:
        cd = self.context.get_context_data(ct.parms_id)
        if cd is None:
            raise ValueError("ciphertext is not valid for encryption parameters")
        if ct.seed_info is not None:
            # c1 of a seeded ciphertext is for serialization only
            # (is_buffer_valid rejection of seeded objects, ciphertext.h:711-725)
            raise ValueError("ciphertext is not valid for encryption parameters (contains a seed)")
        if ct.size < 2:
            raise ValueError("ciphertext is empty or invalid")
        if not isinstance(ct.data, ShardedTensor) and ct.data.device != self.context.device:
            raise ValueError(f"ciphertext lies on {ct.data.device}, the context on {self.context.device}")
        return cd

    def _check_transparent(self, ct: Ciphertext):
        """Reads one flag back from the device, unless the check is off."""
        if THROW_ON_TRANSPARENT and self.throw_on_transparent and ct.is_transparent():
            raise ValueError("result ciphertext is transparent")

    @staticmethod
    def _check_same(ct1: Ciphertext, ct2: Ciphertext):
        if ct1.parms_id != ct2.parms_id:
            raise ValueError("encrypted1 and encrypted2 parameter mismatch")
        if ct1.is_ntt_form != ct2.is_ntt_form:
            raise ValueError("NTT form mismatch")
        if not are_same_scale(ct1.scale, ct2.scale):
            raise ValueError("scale mismatch")

    def _scheme(self) -> SchemeType:
        return self.context.first_context_data().parms.scheme

    def _elementwise(self, cd: ContextData, data, fn, other=None):
        """fn(x, y, t) on the data's limbs with the level's tables ``t`` of
        them (y None for a unary op), on one device or on each rank's limbs
        of sharded data."""
        if isinstance(data, ShardedTensor) or isinstance(other, ShardedTensor):
            return sharded.elementwise(self._plan, cd, data, fn, other)
        return fn(data, other, cd.limb_tables())

    def _limbwise(self, cd: ContextData, data, fn):
        """fn(x, t, lo, hi) on the data's limbs [lo, hi) with the level's
        tables ``t`` of them: the whole level on one device, or each rank's
        own limbs of sharded data."""
        if isinstance(data, ShardedTensor):
            return sharded.limbwise(self._plan, cd, data, fn)
        return fn(data, cd.limb_tables(), 0, data.shape[-2])

    # ------------------------------------------------------------------
    # negate / add / sub
    # ------------------------------------------------------------------
    def negate(self, ct: Ciphertext) -> Ciphertext:
        cd = self._cd(ct)
        out = ct.copy()
        out.data = self._elementwise(cd, ct.data, lambda x, _, t: U.neg_mod(x, t.q))
        self._check_transparent(out)
        return out

    def _add_sub(self, ct1: Ciphertext, ct2: Ciphertext, is_add: bool) -> Ciphertext:
        self._check_same(ct1, ct2)
        cd = self._cd(ct1)
        factor, body = add_sub_body(cd, ct1.correction_factor, ct2.correction_factor, is_add)
        out = ct1.copy()
        out.data = self._elementwise(cd, ct1.data, body, ct2.data)
        out.correction_factor = factor
        self._check_transparent(out)
        return out

    def add(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        return self._add_sub(ct1, ct2, True)

    def sub(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        return self._add_sub(ct1, ct2, False)

    def add_many(self, cts: Sequence[Ciphertext]) -> Ciphertext:
        if not cts:
            raise ValueError("encrypteds cannot be empty")
        acc = cts[0]
        for ct in cts[1:]:
            acc = self.add(acc, ct)
        return acc

    # ------------------------------------------------------------------
    # multiply
    # ------------------------------------------------------------------
    def multiply(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        if ct1.parms_id != ct2.parms_id:
            raise ValueError("encrypted1 and encrypted2 parameter mismatch")
        scheme = self.context.first_context_data().parms.scheme
        if scheme == SchemeType.BFV:
            out = self._bfv_multiply(ct1, ct2)
        elif scheme in (SchemeType.CKKS, SchemeType.BGV):
            out = self._ntt_multiply(ct1, ct2)
        else:
            raise ValueError("unsupported scheme")
        self._check_transparent(out)
        return out

    def square(self, ct: Ciphertext) -> Ciphertext:
        return self.multiply(ct, ct)

    def multiply_many(self, cts: Sequence[Ciphertext], relin_keys: RelinKeys) -> Ciphertext:
        """Binary-tree product, BFV and BGV only (evaluator.cpp:1649-1724)."""
        return multiply_tree(self, cts, relin_keys)

    def exponentiate(self, ct: Ciphertext, exponent: int, relin_keys: RelinKeys) -> Ciphertext:
        if exponent == 0:
            raise ValueError("exponent cannot be 0")
        return self.multiply_many([ct] * exponent, relin_keys)

    def _bfv_multiply(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        """The BEHZ multiply (evaluator.cpp:395-567, ``bfv_bodies.multiply``);
        ``multiply(ct, ct)`` squares."""
        if ct1.is_ntt_form or ct2.is_ntt_form:
            raise ValueError("encrypted1 or encrypted2 cannot be in NTT form")
        cd = self._cd(ct1)
        self._cd(ct2)
        out = ct1.copy()
        out.data = bfv_product(cd, ct1.data, ct2.data)
        return out

    def _ntt_multiply(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        """CKKS's and BGV's multiply: the NTT-domain convolution, with the
        product of the scales (CKKS) or of the correction factors mod t
        (BGV)."""
        if not (ct1.is_ntt_form and ct2.is_ntt_form):
            raise ValueError("encrypted1 and encrypted2 must be in NTT form")
        cd = self._cd(ct1)
        self._cd(ct2)
        out = ct1.copy()
        out.data = ntt_product(self._plan, cd, ct1.data, ct2.data)
        if cd.parms.scheme == SchemeType.BGV:
            out.correction_factor = ct1.correction_factor * ct2.correction_factor % cd.parms.plain_modulus.value
            return out
        out.scale = ct1.scale * ct2.scale
        if not _is_scale_within_bounds(out.scale, cd):
            raise ValueError("scale out of bounds")
        return out

    # ------------------------------------------------------------------
    # key switching core (evaluator.cpp:2561-2867)
    # ------------------------------------------------------------------
    def _plan(self, cd: ContextData, device=None) -> KeySwitchPlan:
        device = cd.device if device is None else torch.device(device)
        plan = self._plans.get((cd.parms_id, device))
        if plan is None:
            plan = KeySwitchPlan(self.context, cd, device)
            self._plans[(cd.parms_id, device)] = plan
        return plan

    def _switch_key(self, ct: Ciphertext, target: int, key: dict) -> Ciphertext:
        """Returns polys [0, target) of ct with the key switch of poly
        ``target`` (one RNS polynomial in the ciphertext's domain) added
        into polys 0 and 1."""
        cd = self._cd(ct)
        scheme = cd.parms.scheme
        if scheme == SchemeType.BFV and ct.is_ntt_form:
            raise ValueError("BFV encrypted cannot be in NTT form")
        if scheme in (SchemeType.CKKS, SchemeType.BGV) and not ct.is_ntt_form:
            raise ValueError(f"{scheme.name} encrypted must be in NTT form")
        if not self.context.using_keyswitching:
            raise ValueError("keyswitching is not supported by the context")
        D = len(cd.parms.coeff_modulus)
        if key is None or key["c0"].shape[0] < D:
            raise ValueError("key-switching keys are invalid for encryption parameters")
        out = ct.copy()
        if isinstance(ct.data, ShardedTensor):
            out.data = sharded.switch_key(self._plan, cd, ct.data, target, key)
        else:
            out.data = self._switch_key_body(cd, target, ct.data, ct.data[target], key["c0"], key["c1"])
        return out

    def _switch_key_body(self, cd: ContextData, ct_size: int, ct_data: torch.Tensor,
                         target: torch.Tensor, key_c0: torch.Tensor, key_c1: torch.Tensor) -> torch.Tensor:
        plan = self._plan(cd)
        D = plan.D
        prod = key_switch_contract(plan, target, key_c0[:D], key_c1[:D], 0, D)  # (2, Rn, n) < q_i
        return key_switch_tail(plan, prod, ct_data[..., :ct_size, :, :], 0, D)

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
            # key for secret power = index of the removed polynomial
            if not relin_keys.has_key(out.size - 1):
                raise ValueError("relin_keys is missing required key")
            out = self._switch_key(out, out.size - 1, relin_keys.key(out.size - 1))
        self._check_transparent(out)
        return out

    # ------------------------------------------------------------------
    # rescaling
    # ------------------------------------------------------------------
    def _mod_switch_scale_to_next(self, ct: Ciphertext) -> Ciphertext:
        cd = self._cd(ct)
        scheme = cd.parms.scheme
        if scheme == SchemeType.BFV and ct.is_ntt_form:
            raise ValueError("BFV encrypted cannot be in NTT form")
        if scheme in (SchemeType.CKKS, SchemeType.BGV) and not ct.is_ntt_form:
            raise ValueError(f"{scheme.name} encrypted must be in NTT form")
        next_cd = cd.next_context_data
        if next_cd is None:
            raise ValueError("end of modulus switching chain reached")
        if scheme == SchemeType.BFV:
            # divide and round by q_last on the coefficients; the scale stays
            return Ciphertext(switch_last_prime(cd, ct.data), next_cd.parms_id, False, ct.scale,
                              ct.correction_factor)
        if scheme == SchemeType.BGV:
            # both polys in one call: one launch of kernel A per transform
            return Ciphertext(switch_last_prime(cd, ct.data), next_cd.parms_id, True, ct.scale,
                              bgv_switched_factor(cd, ct.correction_factor))
        # both the current and the destination scale must stay normal and
        # in bounds (evaluator.cpp:1232-1238)
        if not _is_scale_within_bounds(ct.scale, cd) or not _is_scale_within_bounds(
            ct.scale / cd.coeff_modulus_values[-1], next_cd
        ):
            raise ValueError("scale out of bounds")
        return Ciphertext(
            data=switch_last_prime(cd, ct.data),
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

    def rescale_to(self, ct: Ciphertext, parms_id: ParmsId) -> Ciphertext:
        target = self.context.get_context_data(parms_id)
        cd = self._cd(ct)
        if target is None or cd.chain_index < target.chain_index:
            raise ValueError("cannot switch to higher level modulus")
        out = ct
        while out.parms_id != parms_id:
            out = self.rescale_to_next(out)
        return out

    # ------------------------------------------------------------------
    # modulus switching by dropping limbs
    # ------------------------------------------------------------------
    def _mod_switch_drop_to_next(self, ct: Ciphertext) -> Ciphertext:
        cd = self._cd(ct)
        next_cd = cd.next_context_data
        if next_cd is None:
            raise ValueError("end of modulus switching chain reached")
        if cd.parms.scheme == SchemeType.CKKS and not _is_scale_within_bounds(ct.scale, next_cd):
            raise ValueError("scale out of bounds")
        out = ct.copy()
        out.data = drop_limbs(ct.data, len(next_cd.parms.coeff_modulus))
        out.parms_id = next_cd.parms_id
        return out

    def mod_switch_to_next(self, ct: Ciphertext) -> Ciphertext:
        self._cd(ct)
        if self._scheme() == SchemeType.CKKS:
            out = self._mod_switch_drop_to_next(ct)
        else:
            out = self._mod_switch_scale_to_next(ct)
        self._check_transparent(out)
        return out

    def mod_switch_to(self, ct: Ciphertext, parms_id: ParmsId) -> Ciphertext:
        cd = self._cd(ct)
        target = self.context.get_context_data(parms_id)
        if target is None:
            raise ValueError("parms_id is not valid")
        if cd.chain_index < target.chain_index:
            raise ValueError("cannot switch to higher level modulus")
        out = ct
        while out.parms_id != parms_id:
            out = self.mod_switch_to_next(out)
        return out

    def mod_switch_plain_to(self, plain: Plaintext, parms_id: ParmsId) -> Plaintext:
        """NTT-form plaintext: drop limbs only."""
        if not plain.is_ntt_form:
            raise ValueError("plain is not in NTT form")
        cd = self.context.get_context_data(plain.parms_id)
        target = self.context.get_context_data(parms_id)
        if cd is None or target is None:
            raise ValueError("parms_id is not valid")
        if cd.chain_index < target.chain_index:
            raise ValueError("cannot switch to higher level modulus")
        out = plain.copy()
        out.rns_data = drop_limbs(plain.rns_data, len(target.parms.coeff_modulus))
        out.parms_id = tuple(parms_id)
        return out

    def mod_reduce_to_next(self, ct: Ciphertext) -> Ciphertext:
        out = self._mod_switch_drop_to_next(ct)
        self._check_transparent(out)
        return out

    def mod_reduce_to(self, ct: Ciphertext, parms_id: ParmsId) -> Ciphertext:
        out = ct
        while out.parms_id != parms_id:
            out = self.mod_reduce_to_next(out)
        return out

    # ------------------------------------------------------------------
    # plaintext ops
    # ------------------------------------------------------------------
    def add_plain(self, ct: Ciphertext, plain: Plaintext) -> Ciphertext:
        return self._add_sub_plain(ct, plain, True)

    def sub_plain(self, ct: Ciphertext, plain: Plaintext) -> Ciphertext:
        return self._add_sub_plain(ct, plain, False)

    def _add_sub_plain(self, ct: Ciphertext, plain: Plaintext, is_add: bool) -> Ciphertext:
        cd = self._cd(ct)
        term = plain_term(ct, plain, cd)
        out = ct.copy()
        out.data = self._limbwise(cd, ct.data, lambda x, t, lo, hi: add_sub_plain(
            x, term[lo:hi].to(x.device), t.q, is_add))
        self._check_transparent(out)
        return out

    def multiply_plain(self, ct: Ciphertext, plain: Plaintext) -> Ciphertext:
        self._cd(ct)
        if ct.is_ntt_form and plain.is_ntt_form:
            out = self._multiply_plain_ntt(ct, plain)
        elif not ct.is_ntt_form and not plain.is_ntt_form:
            out = self._multiply_plain_normal(ct, plain)
        elif ct.is_ntt_form:
            # NTT ciphertext x coefficient plaintext: lift the plaintext
            out = self._multiply_plain_ntt(ct, self.transform_plain_to_ntt(plain, ct.parms_id))
        else:
            # coefficient ciphertext x NTT plaintext: transform the ciphertext,
            # multiply in the NTT domain, transform back (evaluator.cpp:2006-2010)
            out = self.transform_from_ntt(self._multiply_plain_ntt(self.transform_to_ntt(ct), plain))
        self._check_transparent(out)
        return out

    def _multiply_plain_ntt(self, ct: Ciphertext, plain: Plaintext) -> Ciphertext:
        if ct.parms_id != plain.parms_id:
            raise ValueError("encrypted and plain parameter mismatch")
        cd = self._cd(ct)
        scale = ct.scale * plain.scale
        if not _is_scale_within_bounds(scale, cd):
            raise ValueError("scale out of bounds")
        out = ct.copy()
        out.data = self._limbwise(cd, ct.data, lambda x, t, lo, hi: U.mul_mod(
            x, plain.rns_data[lo:hi].to(x.device), t.q, t.ratio_lo, t.ratio_hi))
        out.scale = scale
        return out

    def _multiply_plain_normal(self, ct: Ciphertext, plain: Plaintext) -> Ciphertext:
        cd = self._cd(ct)
        scale = ct.scale * plain.scale
        if not _is_scale_within_bounds(scale, cd):
            raise ValueError("scale out of bounds")
        out = ct.copy()
        out.data = self._limbwise(cd, ct.data, multiply_plain_normal_body(cd, plain))
        out.scale = scale
        return out

    # ------------------------------------------------------------------
    # NTT transforms
    # ------------------------------------------------------------------
    def transform_plain_to_ntt(self, plain: Plaintext, parms_id: ParmsId) -> Plaintext:
        """Lift a coefficient plaintext to RNS base q and NTT (evaluator.cpp:2196+)."""
        if plain.is_ntt_form:
            raise ValueError("plain is already in NTT form")
        cd = self.context.get_context_data(parms_id)
        if cd is None:
            raise ValueError("parms_id is not valid")
        out = plain.copy()
        out.rns_data = bgv_lift_plain(plain, cd)
        out.parms_id = tuple(parms_id)
        out.coeff_data = np.zeros(0, dtype=np.uint64)
        return out

    def transform_to_ntt(self, ct: Ciphertext) -> Ciphertext:
        if ct.is_ntt_form:
            raise ValueError("encrypted is already in NTT form")
        cd = self._cd(ct)
        out = ct.copy()
        out.data = self._limbwise(cd, ct.data, lambda x, t, lo, hi: NTT.forward(x, t))
        out.is_ntt_form = True
        return out

    def transform_from_ntt(self, ct: Ciphertext) -> Ciphertext:
        if not ct.is_ntt_form:
            raise ValueError("encrypted is not in NTT form")
        cd = self._cd(ct)
        out = ct.copy()
        out.data = self._limbwise(cd, ct.data, lambda x, t, lo, hi: NTT.inverse(x, t))
        out.is_ntt_form = False
        return out

    # ------------------------------------------------------------------
    # Galois automorphisms and rotations (evaluator.cpp:2384-2559)
    # ------------------------------------------------------------------
    def apply_galois(self, ct: Ciphertext, galois_elt: int, galois_keys: GaloisKeys) -> Ciphertext:
        cd = self._cd(ct)
        if galois_keys.parms_id != self.context.key_parms_id:
            raise ValueError("galois_keys is not valid for encryption parameters")
        n = cd.parms.poly_modulus_degree
        scheme = cd.parms.scheme
        if scheme == SchemeType.BFV and ct.is_ntt_form:
            raise ValueError("BFV encrypted cannot be in NTT form")
        if scheme in (SchemeType.CKKS, SchemeType.BGV) and not ct.is_ntt_form:
            raise ValueError(f"{scheme.name} encrypted must be in NTT form")
        if not (galois_elt & 1) or galois_elt >= 2 * n:
            raise ValueError("Galois element is not valid")
        if ct.size > 2:
            raise ValueError("encrypted size must be 2")
        if not galois_keys.has_key(galois_elt):
            raise ValueError("Galois key not present")
        key = galois_keys.key(galois_elt)
        if key is None or key["c0"].shape[0] < len(cd.parms.coeff_modulus):
            raise ValueError("key-switching keys are invalid for encryption parameters")
        out = ct.copy()
        if isinstance(ct.data, ShardedTensor):
            out.data = sharded.galois(self._plan, cd, ct.data, galois_elt, key)
        else:
            out.data = galois(self._plan(cd), ct.data, galois_tables(cd, galois_elt, ct.data.device),
                              key["c0"], key["c1"])
        self._check_transparent(out)
        return out

    def _rotate_internal(self, ct: Ciphertext, steps: int, galois_keys: GaloisKeys) -> Ciphertext:
        cd = self._cd(ct)
        if not cd.qualifiers.using_batching:
            raise ValueError("encryption parameters do not support batching")
        return rotate_by_steps(self.apply_galois, cd.galois_tool, ct, steps, galois_keys)

    def rotate_rows(self, ct: Ciphertext, steps: int, galois_keys: GaloisKeys) -> Ciphertext:
        if self._scheme() not in (SchemeType.BFV, SchemeType.BGV):
            raise ValueError("unsupported scheme")
        return self._rotate_internal(ct, steps, galois_keys)

    def rotate_columns(self, ct: Ciphertext, galois_keys: GaloisKeys) -> Ciphertext:
        if self._scheme() not in (SchemeType.BFV, SchemeType.BGV):
            raise ValueError("unsupported scheme")
        cd = self._cd(ct)
        return self.apply_galois(ct, 2 * cd.parms.poly_modulus_degree - 1, galois_keys)

    def rotate_vector(self, ct: Ciphertext, steps: int, galois_keys: GaloisKeys) -> Ciphertext:
        if self._scheme() != SchemeType.CKKS:
            raise ValueError("unsupported scheme")
        return self._rotate_internal(ct, steps, galois_keys)

    def complex_conjugate(self, ct: Ciphertext, galois_keys: GaloisKeys) -> Ciphertext:
        if self._scheme() != SchemeType.CKKS:
            raise ValueError("unsupported scheme")
        cd = self._cd(ct)
        return self.apply_galois(ct, 2 * cd.parms.poly_modulus_degree - 1, galois_keys)


def multiply_tree(ev, items, relin_keys):
    """multiply_many's binary-tree product, relinearizing after each
    multiply (evaluator.cpp:1649-1724); ``ev`` is an Evaluator or a
    BatchEvaluator, ``items`` its ciphertexts or batches."""
    if not items:
        raise ValueError("encrypteds cannot be empty")
    scheme = ev.context.first_context_data().parms.scheme
    if scheme not in (SchemeType.BFV, SchemeType.BGV):
        raise ValueError("unsupported scheme")
    queue = list(items)
    while len(queue) > 1:
        pairs = [ev.relinearize(ev.multiply(queue[i], queue[i + 1]), relin_keys) for i in range(0, len(queue) - 1, 2)]
        queue = pairs + queue[len(queue) - len(queue) % 2:]
    return queue[0]


def bgv_switched_factor(cd: ContextData, factor: int) -> int:
    """A BGV correction factor after the modulus switch from ``cd``'s level:
    times q_last^-1 mod t at that level."""
    return factor * cd.rns_tool.inv_q_last_mod_t % cd.parms.plain_modulus.value


def plain_term(ct, plain: Plaintext, cd: ContextData) -> torch.Tensor:
    """The (k, n) term add_plain and sub_plain put into c0 of ``ct`` (a
    ciphertext or a batch), after the reference's checks: round(Delta m) in
    coefficient form for BFV, the NTT-form plaintext for CKKS, and for BGV
    the plaintext times ``ct``'s correction factor mod t, lifted into base q
    in NTT form."""
    scheme = cd.parms.scheme
    if scheme == SchemeType.BFV:
        if ct.is_ntt_form or plain.is_ntt_form:
            raise ValueError("BFV operands cannot be in NTT form")
        return scaling_variant_term(plain, cd, cd.device)
    if scheme == SchemeType.BGV:
        if not ct.is_ntt_form:
            raise ValueError("BGV encrypted must be in NTT form")
        if plain.is_ntt_form:
            raise ValueError("BGV plain cannot be in NTT form")
        scaled = plain.copy()
        tv = cd.parms.plain_modulus.value
        scaled.coeff_data = (plain.coeff_data.astype(object) * ct.correction_factor % tv).astype(np.uint64)
        return bgv_lift_plain(scaled, cd)
    if scheme != SchemeType.CKKS:
        raise ValueError("unsupported scheme")
    if not ct.is_ntt_form or not plain.is_ntt_form:
        raise ValueError("CKKS operands must be in NTT form")
    if ct.parms_id != plain.parms_id:
        raise ValueError("encrypted and plain parameter mismatch")
    if not are_same_scale(ct.scale, plain.scale):
        raise ValueError("scale mismatch")
    return plain.rns_data


def galois_tables(cd: ContextData, galois_elt: int, device):
    """The permutation tensors of ``ckks_bodies.galois`` for the level's
    scheme: the NTT-domain index for CKKS and BGV, the coefficient-domain
    (index, negate) pair for BFV."""
    tool = cd.galois_tool
    if cd.parms.scheme in (SchemeType.CKKS, SchemeType.BGV):
        return (tool.ntt_index(galois_elt, device),)
    return tool.coeff_index(galois_elt, device)


def rotate_by_steps(apply_galois, tool, x, steps: int, galois_keys: GaloisKeys):
    """Rotate ``x`` by ``steps`` slots: one ``apply_galois`` with the step's
    key, or, without it, one per term of the step's non-adjacent form
    (evaluator.cpp:2538-2557)."""
    if steps == 0:
        return x
    elt = tool.get_elt_from_step(steps)
    if galois_keys.has_key(elt):
        return apply_galois(x, elt, galois_keys)
    naf_steps = numth.naf(steps)
    if len(naf_steps) == 1:
        raise ValueError("Galois key not present")
    for s in naf_steps:
        x = rotate_by_steps(apply_galois, tool, x, s, galois_keys)
    return x


def bfv_product(cd: ContextData, d1, d2):
    """BFV's BEHZ product of two ciphertexts' or batches' data, on one
    device or on a mesh; ``d2 is d1`` squares."""
    if isinstance(d1, ShardedTensor) or isinstance(d2, ShardedTensor):
        return sharded.bfv_multiply(cd, d1, d2)
    return bfv_bodies.multiply(d1, d2, cd)


def ntt_product(plan_for, cd: ContextData, d1, d2):
    """CKKS's and BGV's product: the dyadic convolution of NTT-form data,
    on one device or on each rank's limbs."""
    if isinstance(d1, ShardedTensor) or isinstance(d2, ShardedTensor):
        return sharded.multiply(plan_for, cd, d1, d2)
    return convolve(d1, d2, cd.limb_tables())


def switch_last_prime(cd: ContextData, data):
    """The data at ``cd``'s level switched to the next by its last prime:
    the CKKS rescale, BFV's divide-and-round on the coefficients, BGV's
    mod-t switch (its correction factor: :func:`bgv_switched_factor`); on
    one device or on a mesh."""
    if isinstance(data, ShardedTensor):
        return sharded.mod_switch(cd, data)
    scheme = cd.parms.scheme
    if scheme == SchemeType.BFV:
        return R.divide_and_round_q_last(data, cd.rns_tool)
    if scheme == SchemeType.BGV:
        return R.mod_t_and_divide_q_last_ntt(data, cd.rns_tool, cd.limb_tables())
    return R.divide_and_round_q_last_ntt(data, cd.rns_tool, cd.limb_tables())


def drop_limbs(data, k_next: int):
    """The first ``k_next`` RNS limbs (axis -2) of a ciphertext's or a
    plaintext's data, contiguous, as the kernels take it; re-split over the
    limb axis for sharded data."""
    if isinstance(data, ShardedTensor):
        return sharded.drop_limbs(data, k_next)
    return data[..., :k_next, :].contiguous()


def add_sub_plain(x: torch.Tensor, p: torch.Tensor, q: torch.Tensor, is_add: bool) -> torch.Tensor:
    """(c0 +- p) mod q on the polynomial axis -3 of (..., size, k, n) data;
    the other polys are copied."""
    c0 = (U.add_mod if is_add else U.sub_mod)(x[..., :1, :, :], p, q)
    return torch.cat([c0, x[..., 1:, :, :]], dim=-3)


def multiply_plain_normal_body(cd: ContextData, plain: Plaintext):
    """The body of a coefficient-form multiply_plain (evaluator.cpp:2021-2155)
    as fn(x, t, lo, hi), for the limbs [lo, hi) of the level.  A plaintext
    with one nonzero coefficient multiplies by a monomial: a constant per
    limb and a negacyclic shift (the reference's fast path; it branches on
    the plaintext's structure, a timing dependence the reference documents
    at evaluator.cpp:2044-2047).  Any other plaintext is lifted and
    NTT-transformed once, and each poly goes through the NTT and back."""
    sig = plain.significant_coeff_count()
    if int(np.count_nonzero(plain.coeff_data)) == 1:
        exp = sig - 1
        coeff = int(plain.coeff_data[exp])
        qv = cd.coeff_modulus_values
        if coeff >= cd.plain_upper_half_threshold:
            if not cd.qualifiers.using_fast_plain_lift:
                lifted_c = coeff + (cd.total_coeff_modulus - cd.parms.plain_modulus.value)
                mono = [lifted_c % q for q in qv]
            else:
                mono = [(coeff + inc) % q for q, inc in zip(qv, cd.plain_upper_half_increment)]
        else:
            mono = [coeff % q for q in qv]

        def mono_body(x, t, lo, hi):
            return P.mono_multiply(x, _c(mono[lo:hi], x.device), exp, t.q, t.ratio_lo, t.ratio_hi)

        return mono_body
    lifted = bgv_lift_plain(plain, cd)          # (k, n) NTT form

    def general_body(x, t, lo, hi):
        px = U.mul_mod(NTT.forward(x, t, lazy=True), lifted[lo:hi].to(x.device), t.q, t.ratio_lo, t.ratio_hi)
        return NTT.inverse(px, t)

    return general_body
