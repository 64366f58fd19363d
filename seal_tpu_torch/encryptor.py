"""Encryptor: public- and secret-key encryption, CKKS.

Port of the CKKS part of ``seal_tpu/encryptor.py`` (counterpart of
``encryptor.{h,cpp}``): an encryption of zero at the plaintext's level with
the NTT-form plaintext added into c0.  BFV's scaling variant and BGV's
plaintext lift raise ``NotImplementedError`` naming their ROADMAP.md items.
"""

from __future__ import annotations

from typing import Optional

from .context import SealContext
from .data import Ciphertext, Plaintext, PublicKey, SecretKey
from .params import ParmsId, SchemeType, not_ported
from .ops import u64 as U
from .rlwe import encrypt_zero_asymmetric, encrypt_zero_symmetric


class Encryptor:
    def __init__(self, context: SealContext, public_key: Optional[PublicKey] = None,
                 secret_key: Optional[SecretKey] = None):
        if not context.parameters_set:
            raise ValueError("encryption parameters are not set correctly")
        if public_key is None and secret_key is None:
            raise ValueError("at least one of public/secret key must be given")
        scheme = context.key_context_data().parms.scheme
        if scheme != SchemeType.CKKS:
            raise not_ported(scheme)
        self.context = context
        self._public_key = public_key
        self._secret_key = secret_key

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
        if not is_asymmetric:
            if self._secret_key is None:
                raise ValueError("secret key is not set")
            return encrypt_zero_symmetric(self._secret_key, self.context, parms_id, save_seed)
        if self._public_key is None:
            raise ValueError("public key is not set")
        if cd.chain_index < self.context.first_context_data().chain_index:
            # the JAX package encrypts at the first level and mod-switches down
            raise NotImplementedError("public-key encryption below the first level needs mod_switch_to_next "
                                      "(ROADMAP.md queue 1, item 8)")
        return encrypt_zero_asymmetric(self._public_key, self.context, parms_id)

    # -- plaintext encryptions --------------------------------------------
    def encrypt(self, plain: Plaintext) -> Ciphertext:
        return self._encrypt_internal(plain, is_asymmetric=True, save_seed=False)

    def encrypt_symmetric(self, plain: Plaintext, save_seed: bool = False) -> Ciphertext:
        return self._encrypt_internal(plain, is_asymmetric=False, save_seed=save_seed)

    def _encrypt_internal(self, plain: Plaintext, is_asymmetric: bool, save_seed: bool) -> Ciphertext:
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
