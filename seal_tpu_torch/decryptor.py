"""Decryptor: the dot product of a ciphertext with powers of the secret key.

Port of the CKKS part of ``seal_tpu/decryptor.py`` (counterpart of
``decryptor.{h,cpp}``): c0 + c1 s + c2 s^2 + ... in the NTT domain
(``decryptor.cpp:320-407``), returned as an NTT-form plaintext.  BFV's and
BGV's decoding tails and the noise budget raise ``NotImplementedError``
naming their ROADMAP.md items.
"""

from __future__ import annotations

from typing import List

import torch

from .context import SealContext
from .data import Ciphertext, Plaintext, SecretKey
from .params import SchemeType, not_ported
from .ops import u64 as U


class Decryptor:
    def __init__(self, context: SealContext, secret_key: SecretKey):
        if not context.parameters_set:
            raise ValueError("encryption parameters are not set correctly")
        if secret_key.parms_id != context.key_parms_id:
            raise ValueError("secret key is not valid for encryption parameters")
        self.context = context
        self._sk_powers: List[torch.Tensor] = [secret_key.data]   # s, s^2, ... NTT form, key level

    def _secret_key_power(self, power: int) -> torch.Tensor:
        t = self.context.key_context_data().limb_tables()
        while len(self._sk_powers) < power:
            self._sk_powers.append(U.mul_mod(self._sk_powers[-1], self._sk_powers[0], t.q, t.ratio_lo, t.ratio_hi))
        return self._sk_powers[power - 1]

    def decrypt(self, ct: Ciphertext) -> Plaintext:
        if ct.size < 2:
            raise ValueError("encrypted is empty")
        scheme = self.context.first_context_data().parms.scheme
        if scheme != SchemeType.CKKS:
            raise not_ported(scheme)
        if not ct.is_ntt_form:
            raise ValueError("encrypted must be in NTT form")
        cd = self.context.get_context_data(ct.parms_id)
        if cd is None:
            raise ValueError("encrypted is not valid for encryption parameters")
        t = cd.limb_tables()
        k = ct.coeff_modulus_size
        phase = ct.data[0]
        for j in range(1, ct.size):
            prod = U.mul_mod(ct.data[j], self._secret_key_power(j)[:k], t.q, t.ratio_lo, t.ratio_hi)
            phase = U.add_mod(phase, prod, t.q)
        p = Plaintext()
        p.parms_id = ct.parms_id
        p.scale = ct.scale
        p.rns_data = phase
        return p

    def invariant_noise_budget(self, ct: Ciphertext) -> int:
        raise NotImplementedError("the noise budget is a BFV and BGV measure; BFV and BGV are not ported yet "
                                  "(ROADMAP.md queue 1, items 9 and 10)")
