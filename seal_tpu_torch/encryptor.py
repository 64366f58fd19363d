"""Encryptor: public- and secret-key encryption for BFV, CKKS and BGV, and
the plaintext paths' helpers.

Port of ``seal_tpu/encryptor.py`` (counterpart of ``encryptor.{h,cpp}``):
CKKS adds the NTT-form plaintext into c0 of an NTT-form encryption of zero
at the plaintext's level; BFV adds round(Delta * m), Delta = floor(q/t),
into c0 of a coefficient-form encryption of zero at the first level (the
scaling variant, ``scalingvariant.cpp:69-161``,
:func:`multiply_add_plain_with_scaling_variant`, whose term BFV's
add_plain and sub_plain share); BGV adds the coefficient plaintext, lifted
into base q in NTT form (:func:`bgv_lift_plain`, which the evaluator's
plaintext paths share), into c0 of an NTT-form encryption of zero at the
first level.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .context import ContextData, SealContext
from .data import Ciphertext, Plaintext, PublicKey, SecretKey
from .ntt_tables import u64_tensor
from .params import ParmsId, SchemeType
from .ops import ntt as NTT
from .ops import u64 as U
from .ops.rns import _cshoup
from .rlwe import encrypt_zero_asymmetric, encrypt_zero_symmetric


def _scaling_variant_fix(plain: Plaintext, cd: ContextData) -> np.ndarray:
    """Per coefficient: floor(((q mod t) m + (t + 1) / 2) / t), exact on the host."""
    t = cd.parms.plain_modulus.value
    q_mod_t = cd.coeff_modulus_mod_plain_modulus
    thr = cd.plain_upper_half_threshold
    return np.array([(int(m) * q_mod_t + thr) // t for m in plain.coeff_data], dtype=np.uint64)


def scaling_variant_term(plain: Plaintext, cd: ContextData, device) -> torch.Tensor:
    """round(Delta m) = Delta m + fix mod q at ``cd``'s level, (k, n) in
    coefficient form on ``device``: what BFV adds into c0."""
    n = cd.parms.poly_modulus_degree
    count = len(plain.coeff_data)
    m = np.zeros(n, dtype=np.uint64)
    m[:count] = plain.coeff_data
    fix = np.zeros(n, dtype=np.uint64)
    fix[:count] = _scaling_variant_fix(plain, cd)
    t = cd.limb_tables(device)
    scaled = U.mul_mod_shoup(u64_tensor(m[None, :], device), *_cshoup(cd.coeff_div_plain_modulus,
                                                                        cd.coeff_modulus_values, device), t.q)
    return U.add_mod(scaled, U.barrett_reduce_64(u64_tensor(fix[None, :], device), t.q, t.ratio_hi), t.q)


def multiply_add_plain_with_scaling_variant(plain: Plaintext, cd: ContextData, c0: torch.Tensor,
                                            negate: bool = False) -> torch.Tensor:
    """c0 + round(Delta m) mod q, or c0 minus it with ``negate``; ``c0``
    is (..., k, n) in coefficient form at ``cd``'s level."""
    term = scaling_variant_term(plain, cd, c0.device)
    q = cd.limb_tables(c0.device).q
    return U.sub_mod(c0, term, q) if negate else U.add_mod(c0, term, q)


def bgv_lift_plain(plain: Plaintext, cd: ContextData) -> torch.Tensor:
    """Lift a coefficient plaintext into RNS base q and NTT-transform it:
    (k, n) int64 on the context's device.  A coefficient at or above
    ``plain_upper_half_threshold`` stands for a negative value and is
    lifted by ``plain_upper_half_increment`` (fast lift) or by Q - t.  The
    lift runs in numpy on the host, the NTT on the device."""
    n = cd.parms.poly_modulus_degree
    qv = cd.coeff_modulus_values
    m = np.zeros(n, dtype=np.uint64)
    m[: len(plain.coeff_data)] = plain.coeff_data
    big = m >= np.uint64(cd.plain_upper_half_threshold)
    out = np.zeros((len(qv), n), dtype=np.uint64)
    if cd.qualifiers.using_fast_plain_lift:
        for i, inc in enumerate(cd.plain_upper_half_increment):
            out[i] = np.where(big, m + np.uint64(inc), m)
    else:
        # (v + Q - t) mod q_i, exactly, in uint64: every residue stays below 2^62
        total_inc = cd.total_coeff_modulus - cd.parms.plain_modulus.value
        for i, q in enumerate(qv):
            r = m % np.uint64(q)
            out[i] = np.where(big, (r + np.uint64(total_inc % q)) % np.uint64(q), r)
    return NTT.forward(u64_tensor(out, cd.device), cd.limb_tables())


class Encryptor:
    def __init__(self, context: SealContext, public_key: Optional[PublicKey] = None,
                 secret_key: Optional[SecretKey] = None):
        if not context.parameters_set:
            raise ValueError("encryption parameters are not set correctly")
        if public_key is None and secret_key is None:
            raise ValueError("at least one of public/secret key must be given")
        self.context = context
        self._public_key = public_key
        self._secret_key = secret_key

    def set_public_key(self, pk: PublicKey):
        self._public_key = pk

    def set_secret_key(self, sk: SecretKey):
        self._secret_key = sk

    # -- zero encryptions --------------------------------------------------
    def encrypt_zero(self, parms_id: Optional[ParmsId] = None) -> Ciphertext:
        return self._encrypt_zero_internal(parms_id, is_asymmetric=True, save_seed=False)

    def encrypt_zero_symmetric(self, parms_id: Optional[ParmsId] = None, save_seed: bool = False) -> Ciphertext:
        return self._encrypt_zero_internal(parms_id, is_asymmetric=False, save_seed=save_seed)

    def _encrypt_zero_internal(self, parms_id, is_asymmetric: bool, save_seed: bool) -> Ciphertext:
        if parms_id is None:
            parms_id = self.context.first_parms_id
        cd = self.context.get_context_data(parms_id)
        if cd is None:
            raise ValueError("parms_id is not valid for encryption parameters")
        is_ntt_form = cd.parms.scheme in (SchemeType.CKKS, SchemeType.BGV)
        if not is_asymmetric:
            if self._secret_key is None:
                raise ValueError("secret key is not set")
            return encrypt_zero_symmetric(self._secret_key, self.context, parms_id, is_ntt_form, save_seed)
        if self._public_key is None:
            raise ValueError("public key is not set")
        if cd.chain_index < self.context.first_context_data().chain_index:
            # below the first level: encrypt there and switch down
            # (encryptor.cpp encrypt_zero_internal)
            from .evaluator import Evaluator

            ct = self._encrypt_zero_internal(self.context.first_parms_id, True, save_seed)
            ev = Evaluator(self.context)
            while ct.parms_id != parms_id:
                ct = ev.mod_switch_to_next(ct)
            return ct
        return encrypt_zero_asymmetric(self._public_key, self.context, parms_id, is_ntt_form)

    # -- plaintext encryptions --------------------------------------------
    def encrypt(self, plain: Plaintext) -> Ciphertext:
        return self._encrypt_internal(plain, is_asymmetric=True, save_seed=False)

    def encrypt_symmetric(self, plain: Plaintext, save_seed: bool = False) -> Ciphertext:
        return self._encrypt_internal(plain, is_asymmetric=False, save_seed=save_seed)

    def _encrypt_internal(self, plain: Plaintext, is_asymmetric: bool, save_seed: bool) -> Ciphertext:
        scheme = self.context.key_context_data().parms.scheme
        if scheme in (SchemeType.BFV, SchemeType.BGV):
            if plain.is_ntt_form:
                raise ValueError("plain cannot be in NTT form")
            ct = self._encrypt_zero_internal(self.context.first_parms_id, is_asymmetric, save_seed)
            cd = self.context.first_context_data()
            data = ct.data.clone()
            if scheme == SchemeType.BFV:
                data[0] = multiply_add_plain_with_scaling_variant(plain, cd, ct.data[0])
            else:
                data[0] = U.add_mod(ct.data[0], bgv_lift_plain(plain, cd), cd.limb_tables().q)
            ct.data = data
            return ct
        if not plain.is_ntt_form:
            raise ValueError("plain must be in NTT form")
        cd = self.context.get_context_data(plain.parms_id)
        if cd is None:
            raise ValueError("plain is not valid for encryption parameters")
        ct = self._encrypt_zero_internal(plain.parms_id, is_asymmetric, save_seed)
        data = ct.data.clone()
        data[0] = U.add_mod(ct.data[0], plain.rns_data, cd.limb_tables().q)
        ct.data = data
        ct.scale = plain.scale
        return ct
