"""Key generation: the secret key, the public key, relinearization keys and
Galois keys.

Port of ``seal_tpu/keygen.py`` (counterpart of ``keygenerator.{h,cpp}``).
A key-switching key follows the reference (``keygenerator.cpp:327-360``):
for decomposition limb i, an NTT-form encryption of zero at the key level
with ``(q_last mod q_i) * target[i]`` added into c0's limb i, stacked over
the decomposition axis.  A Galois key is the key-switching key of the
secret key's automorphism (``keygenerator.cpp`` generate_galois_keys).

The D encryptions of a key sample on the device by default, as in the JAX
package: one set of launches over D streams (kernels C and D, then kernel
A, on the card), byte-identical to the D host-sampled encryptions it
replaces, which serve where ``rlwe.device_sampling`` says no (a PRNG that
is not BLAKE2xb, Gaussian noise, the switch off) and after a
rejection-tail overflow.  The secret key and public-key encryption sample
on the host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .context import SealContext
from .data import GaloisKeys, PublicKey, RelinKeys, SecretKey
from .ntt_tables import u64_tensor
from .ops import ntt as NTT
from .ops import poly as P
from .ops import u64 as U
from .ops.rns import _c, _cshoup
from .random.sampler import sample_poly_ternary
from .rlwe import device_sampling, device_samples, encrypt_zero_symmetric, seed_infos, zero_encryption


class KeyGenerator:
    def __init__(self, context: SealContext, secret_key: Optional[SecretKey] = None):
        if not context.parameters_set:
            raise ValueError("encryption parameters are not set correctly")
        self.context = context
        cd = context.key_context_data()
        if secret_key is None:
            parms = cd.parms
            sk = sample_poly_ternary(parms.random_generator.create(), parms.poly_modulus_degree,
                                     cd.coeff_modulus_values)
            sk_ntt = NTT.forward(u64_tensor(sk, context.device), cd.limb_tables())
            secret_key = SecretKey(sk_ntt, cd.parms_id)
        self._secret_key = secret_key
        self._sk_powers: List[torch.Tensor] = [secret_key.data]   # s, s^2, ... NTT form

    @property
    def secret_key(self) -> SecretKey:
        return self._secret_key

    def _secret_key_power(self, power: int) -> torch.Tensor:
        """s^power in NTT form at the key level (keygenerator.cpp:237-325)."""
        t = self.context.key_context_data().limb_tables()
        while len(self._sk_powers) < power:
            self._sk_powers.append(U.mul_mod(self._sk_powers[-1], self._sk_powers[0], t.q, t.ratio_lo, t.ratio_hi))
        return self._sk_powers[power - 1]

    def create_public_key(self, save_seed: bool = False) -> PublicKey:
        key_id = self.context.key_parms_id
        return PublicKey(encrypt_zero_symmetric(self._secret_key, self.context, key_id, True, save_seed))

    def _generate_one_kswitch_key(self, target: torch.Tensor, save_seed: bool = False) -> dict:
        """D encryptions of zero with (q_last mod q_i) * target[i] added into
        c0's limb i, stacked: {'c0', 'c1': (D, k_key, n), 'seeds'}."""
        if not self.context.using_keyswitching:
            raise ValueError("keyswitching is not supported by the context")
        parms = self.context.key_context_data().parms
        if device_sampling(parms):
            out = self._generate_one_kswitch_key_device(target, save_seed)
            if out is not None:
                return out
        return self._generate_one_kswitch_key_host(target, save_seed)

    def _add_target(self, c0: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """c0 (D, k_key, n) with (q_last mod q_i) * target[i] added into limb i of row i."""
        key_moduli = self.context.key_context_data().coeff_modulus_values
        D = c0.shape[0]
        dev = c0.device
        q = _c(key_moduli, dev)
        op, qt = _cshoup([key_moduli[-1] % qi for qi in key_moduli], key_moduli, dev)
        add_term = U.mul_mod_shoup(target, op, qt, q)                     # (k_key, n)
        diag = torch.arange(D, device=dev)
        c0[diag, diag] = U.add_mod(c0[diag, diag], add_term[:D], q[:D])
        return c0

    def _generate_one_kswitch_key_device(self, target: torch.Tensor, save_seed: bool = False):
        """All D encryptions sampled on the device in one set of launches
        (``seal_tpu/keygen.py:88-156``): D bootstrap seeds drawn from the
        factory in the host path's order, their streams (the public seed,
        then the noise), the uniform c1 over the key level from the public
        seeds.  None after a rejection-tail overflow."""
        context = self.context
        key_cd = context.key_context_data()
        parms = key_cd.parms
        key_moduli = key_cd.coeff_modulus_values
        n = parms.poly_modulus_degree
        D = len(context.first_context_data().parms.coeff_modulus)
        boot_seeds = u64_tensor([parms.random_generator.create().seed for _ in range(D)], context.device)
        samples = device_samples(boot_seeds, 0, n, key_moduli)
        if samples is None:
            return None
        public, a, noise = samples                                        # (D, 8), (D, k_key, n) twice
        c0, c1 = zero_encryption(self._secret_key.data, a, noise, parms, key_moduli, key_cd.limb_tables(),
                                 True, save_seed)
        return {"c0": self._add_target(c0, target), "c1": c1, "seeds": seed_infos(public) if save_seed else None}

    def _generate_one_kswitch_key_host(self, target: torch.Tensor, save_seed: bool = False) -> dict:
        """The D encryptions one after another, sampled on the host."""
        key_cd = self.context.key_context_data()
        D = len(self.context.first_context_data().parms.coeff_modulus)
        cts = [encrypt_zero_symmetric(self._secret_key, self.context, key_cd.parms_id, True, save_seed)
               for _ in range(D)]
        c0 = torch.stack([ct.data[0] for ct in cts])
        c1 = torch.stack([ct.data[1] for ct in cts])
        return {"c0": self._add_target(c0, target), "c1": c1,
                "seeds": [ct.seed_info for ct in cts] if save_seed else None}

    def create_relin_keys(self, count: int = 1, save_seed: bool = False) -> RelinKeys:
        """Keys for s^2 .. s^(count+1) (cf. create_relin_keys_internal)."""
        if not (1 <= count <= 14):  # CIPHERTEXT_SIZE_MAX - 2
            raise ValueError("invalid count")
        keys = RelinKeys()
        keys.keys = [self._generate_one_kswitch_key(self._secret_key_power(power), save_seed)
                     for power in range(2, count + 2)]
        keys.parms_id = self.context.key_parms_id
        return keys

    def create_galois_keys(self, galois_elts: Optional[Sequence[int]] = None,
                           save_seed: bool = False) -> GaloisKeys:
        """Keys for the given Galois elements (default: every power-of-two
        rotation and the conjugation), sampled in the order given."""
        cd = self.context.key_context_data()
        galois_tool = cd.galois_tool
        n = cd.parms.poly_modulus_degree
        if galois_elts is None:
            galois_elts = galois_tool.get_elts_all()
        keys = GaloisKeys()
        # n entries: index = (elt - 1) / 2 < n for odd elt < 2n, and the
        # reference sizes the outer vector to N (the wire format needs it)
        keys.keys = [None] * n
        for elt in galois_elts:
            if not (elt & 1) or elt >= 2 * n:
                raise ValueError("Galois element is not valid")
            index = GaloisKeys.get_index(elt)
            if keys.keys[index] is not None:
                continue
            rotated_sk = P.apply_galois_ntt(self._secret_key.data, galois_tool.ntt_index(elt, self.context.device))
            keys.keys[index] = self._generate_one_kswitch_key(rotated_sk, save_seed)
        keys.parms_id = self.context.key_parms_id
        return keys

    def create_galois_keys_from_steps(self, steps: Sequence[int], save_seed: bool = False) -> GaloisKeys:
        cd = self.context.key_context_data()
        return self.create_galois_keys(cd.galois_tool.get_elts_from_steps(steps), save_seed)
