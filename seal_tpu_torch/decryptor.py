"""Decryptor: the dot product of a ciphertext with powers of the secret key,
then the scheme's decoding tail.

Port of ``seal_tpu/decryptor.py`` (counterpart of ``decryptor.{h,cpp}``):
c0 + c1 s + c2 s^2 + ... (``decryptor.cpp:320-407``), in the NTT domain for
CKKS (returned as an NTT-form plaintext) and BGV, and through it for BFV's
coefficient-form ciphertexts.  BFV's phase goes through the {t, gamma}
scale-and-round (``ops/rns.decrypt_scale_and_round``) to a coefficient
plaintext; BGV's is inverse-transformed, converted exactly to t
(``ops/rns.decrypt_modt``) and divided by the correction factor mod t.
``invariant_noise_budget`` (``decryptor.cpp:409-486``) serves BFV and BGV.
``decrypt_batch`` runs the dot product and the tail once over a
``CiphertextBatch``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import numth
from .context import SealContext
from .convert import u64_to_numpy
from .data import Ciphertext, Plaintext, SecretKey
from .params import SchemeType
from .ops import ntt as NTT
from .ops import rns as R
from .ops import u64 as U
from .ops.rns import _cshoup


def _divide_correction(coeffs: np.ndarray, factor: int, tv: int) -> np.ndarray:
    """BGV's coefficients mod t divided by the correction factor, on the host."""
    if factor == 1:
        return coeffs
    fix = numth.invert_mod(factor, tv)
    if tv.bit_length() + fix.bit_length() <= 64:
        return coeffs * np.uint64(fix) % np.uint64(tv)
    # the product could pass 2^64: Python ints
    return np.array([int(c) * fix % tv for c in coeffs], dtype=np.uint64)


def _trimmed(coeffs: np.ndarray) -> Plaintext:
    """A coefficient plaintext of ``coeffs`` up to the last nonzero one (at
    least one coefficient)."""
    nonzero = np.nonzero(coeffs)[0]
    return Plaintext.from_coeffs(coeffs[: int(nonzero[-1]) + 1 if len(nonzero) else 1])


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

    def _phase(self, ct: Ciphertext) -> torch.Tensor:
        """c0 + c1 s + ... in the ciphertext's domain (NTT or coefficient)."""
        cd = self.context.get_context_data(ct.parms_id)
        if cd is None:
            raise ValueError("encrypted is not valid for encryption parameters")
        return self._phase_of(cd, ct.data, ct.is_ntt_form)

    def _phase_of(self, cd, data: torch.Tensor, is_ntt_form: bool) -> torch.Tensor:
        """The phase of (..., size, k, n) ``data``: one set of launches for
        any number of leading (batch) axes."""
        t = cd.limb_tables()
        size, k = data.shape[-3], data.shape[-2]
        rest = data[..., 1:, :, :]
        if not is_ntt_form:
            rest = NTT.forward(rest.contiguous(), t, lazy=True)
        acc = None
        for j in range(1, size):
            prod = U.mul_mod(rest[..., j - 1, :, :], self._secret_key_power(j)[:k], t.q, t.ratio_lo, t.ratio_hi)
            acc = prod if acc is None else U.add_mod(acc, prod, t.q)
        if not is_ntt_form:
            acc = NTT.inverse(acc, t)
        return U.add_mod(data[..., 0, :, :], acc, t.q)

    def decrypt(self, ct: Ciphertext) -> Plaintext:
        if ct.size < 2:
            raise ValueError("encrypted is empty")
        scheme = self.context.first_context_data().parms.scheme
        if scheme == SchemeType.BFV:
            return self._bfv_decrypt(ct)
        if scheme == SchemeType.BGV:
            return self._bgv_decrypt(ct)
        if scheme != SchemeType.CKKS:
            raise ValueError("unsupported scheme")
        if not ct.is_ntt_form:
            raise ValueError("encrypted must be in NTT form")
        p = Plaintext()
        p.parms_id = ct.parms_id
        p.scale = ct.scale
        p.rns_data = self._phase(ct)
        return p

    def _bfv_decrypt(self, ct: Ciphertext) -> Plaintext:
        if ct.is_ntt_form:
            raise ValueError("encrypted cannot be in NTT form")
        phase = self._phase(ct)
        cd = self.context.get_context_data(ct.parms_id)
        return _trimmed(u64_to_numpy(R.decrypt_scale_and_round(phase, cd.rns_tool))[0])

    def _bgv_decrypt(self, ct: Ciphertext) -> Plaintext:
        if not ct.is_ntt_form:
            raise ValueError("encrypted must be in NTT form")
        cd = self.context.get_context_data(ct.parms_id)
        phase = NTT.inverse(self._phase(ct), cd.limb_tables())
        coeffs = u64_to_numpy(R.decrypt_modt(phase, cd.rns_tool))[0]
        return _trimmed(_divide_correction(coeffs, ct.correction_factor, cd.parms.plain_modulus.value))

    def decrypt_batch(self, batch) -> List[Plaintext]:
        """Decrypt a ``parallel.batch.CiphertextBatch``: the dot product and
        the scheme's tail once over the whole batch, one device-to-host read
        for BFV and BGV (CKKS plaintexts stay on the device).  Equal to
        ``decrypt`` of every ``batch[i]``."""
        if batch.size < 2:
            raise ValueError("encrypted is empty")
        scheme = self.context.first_context_data().parms.scheme
        cd = self.context.get_context_data(batch.parms_id)
        if cd is None:
            raise ValueError("encrypted is not valid for encryption parameters")
        if scheme == SchemeType.BFV and batch.is_ntt_form:
            raise ValueError("encrypted cannot be in NTT form")
        if scheme in (SchemeType.CKKS, SchemeType.BGV) and not batch.is_ntt_form:
            raise ValueError("encrypted must be in NTT form")
        phase = self._phase_of(cd, batch.unshard().data, batch.is_ntt_form)      # (B, k, n)
        if scheme == SchemeType.CKKS:
            plains = []
            for i in range(batch.batch_size):
                p = Plaintext()
                p.parms_id = batch.parms_id
                p.scale = batch.scale
                p.rns_data = phase[i]
                plains.append(p)
            return plains
        if scheme == SchemeType.BFV:
            out = R.decrypt_scale_and_round(phase, cd.rns_tool)
        else:
            out = R.decrypt_modt(NTT.inverse(phase, cd.limb_tables()), cd.rns_tool)
        coeffs = u64_to_numpy(out)[:, 0, :]                                           # (B, n)
        tv = cd.parms.plain_modulus.value
        factor = batch.correction_factor if scheme == SchemeType.BGV else 1
        return [_trimmed(_divide_correction(c, factor, tv)) for c in coeffs]

    def invariant_noise_budget(self, ct: Ciphertext) -> int:
        """Remaining noise budget in bits (decryptor.cpp:409-486): the
        centered infinity norm of the phase in coefficient form (BFV's times
        t), composed on the host."""
        scheme = self.context.key_context_data().parms.scheme
        if scheme not in (SchemeType.BFV, SchemeType.BGV):
            raise ValueError("unsupported scheme")
        if scheme == SchemeType.BFV and ct.is_ntt_form:
            raise ValueError("BFV encrypted cannot be in NTT form")
        if scheme == SchemeType.BGV and not ct.is_ntt_form:
            raise ValueError("BGV encrypted must be in NTT form")
        noise = self._phase(ct)
        cd = self.context.get_context_data(ct.parms_id)
        if scheme == SchemeType.BGV:
            noise = NTT.inverse(noise, cd.limb_tables())
        else:
            qv = cd.coeff_modulus_values
            tv = cd.parms.plain_modulus.value
            noise = U.mul_mod_shoup(noise, *_cshoup([tv % q for q in qv], qv, noise.device), cd.limb_tables().q)
        q_total = cd.total_coeff_modulus
        half = q_total >> 1
        norm = max((q_total - v if v > half else v) for v in cd.base_q.compose_array(u64_to_numpy(noise)))
        return max(0, cd.total_coeff_modulus_bit_count - norm.bit_length() - 1)
