"""RLWE encryptions of zero: the core of keygen and encryption.

Port of the host-sampled path of ``seal_tpu/rlwe.py`` (counterpart of
``util/rlwe.cpp:190-407``): in NTT form for keys, CKKS and BGV
ciphertexts, in coefficient form for BFV ciphertexts
(``is_ntt_form=False``); BGV's noise is t times the sampled one.  Sampling
runs on the host (numpy over the deterministic PRNG byte stream, in the
reference's draw order, the same for both forms); the ring arithmetic runs
on the context's device, every NTT through ``ops/ntt.py``.  The JAX
package's device-sampled path (``ops/blake2_dev.py``) gives the same bytes
and waits for a later slice (ROADMAP.md queue 1, item 6).
"""

from __future__ import annotations

import struct

import torch

from .context import SealContext
from .data import Ciphertext, PublicKey, SecretKey
from .ntt_tables import u64_tensor
from .params import ParmsId, SchemeType
from .ops import ntt as NTT
from .ops import u64 as U
from .ops.rns import _cshoup
from .random import UniformRandomGeneratorFactory
from .random.prng import PRNG_SEED_BYTE_COUNT
from .random.sampler import noise_sampler_for, sample_poly_ternary, sample_poly_uniform


def _times_t(noise: torch.Tensor, parms, moduli, t) -> torch.Tensor:
    """BGV's noise t e mod q_i, for any 64-bit e (a lazy NTT's output too)."""
    tv = parms.plain_modulus.value
    return U.mul_mod_shoup(noise, *_cshoup([tv % q for q in moduli], moduli, noise.device), t.q)


def encrypt_zero_symmetric(secret_key: SecretKey, context: SealContext, parms_id: ParmsId,
                           is_ntt_form: bool, save_seed: bool = False) -> Ciphertext:
    """(c0, c1) = ([-(a s + e)]_q, a) (BGV: t e), in NTT form or in
    coefficient form (rlwe.cpp:277-407).

    ``a`` is expanded from a public seed drawn from the parameters' PRNG;
    with ``save_seed`` the seed is kept in ``seed_info`` so c1 can be
    regenerated.  The uniform sample is a's NTT form, except in coefficient
    form with ``save_seed``, where it is a itself (what the seed
    regenerates).
    """
    cd = context.get_context_data(parms_id)
    parms = cd.parms
    moduli = cd.coeff_modulus_values
    n = parms.poly_modulus_degree
    t = cd.limb_tables()
    dev = context.device

    bootstrap_prng = parms.random_generator.create()
    public_seed = struct.unpack("<8Q", bootstrap_prng.generate(PRNG_SEED_BYTE_COUNT))
    ciphertext_prng = UniformRandomGeneratorFactory.default_factory().create(public_seed)
    c1 = u64_tensor(sample_poly_uniform(ciphertext_prng, n, moduli), dev)
    noise = u64_tensor(noise_sampler_for(parms)(bootstrap_prng, n, moduli), dev)

    c1_ntt = NTT.forward(c1, t) if save_seed and not is_ntt_form else c1
    c0 = U.mul_mod(secret_key.data[: len(moduli)], c1_ntt, t.q, t.ratio_lo, t.ratio_hi)
    if is_ntt_form:
        noise = NTT.forward(noise, t)
    else:
        c0 = NTT.inverse(c0, t)
        if not save_seed:
            c1 = NTT.inverse(c1, t)
    if parms.scheme == SchemeType.BGV:
        noise = _times_t(noise, parms, moduli, t)
    c0 = U.neg_mod(U.add_mod(noise, c0, t.q), t.q)
    ct = Ciphertext(torch.stack([c0, c1]), parms_id, is_ntt_form, 1.0, 1)
    if save_seed:
        ct.seed_info = ciphertext_prng.info()
    return ct


def encrypt_zero_asymmetric(public_key: PublicKey, context: SealContext, parms_id: ParmsId,
                            is_ntt_form: bool) -> Ciphertext:
    """c_j = pk_j u + e_j (BGV: + t e_j), in NTT form or in coefficient form
    (rlwe.cpp:190-275)."""
    cd = context.get_context_data(parms_id)
    parms = cd.parms
    moduli = cd.coeff_modulus_values
    n = parms.poly_modulus_degree
    t = cd.limb_tables()
    k = len(moduli)
    size = public_key.data.size
    dev = context.device

    prng = parms.random_generator.create()
    u = u64_tensor(sample_poly_ternary(prng, n, moduli), dev)
    sampler = noise_sampler_for(parms)
    noise = torch.stack([u64_tensor(sampler(prng, n, moduli), dev) for _ in range(size)])

    u = NTT.forward(u, t)
    c = U.mul_mod(u, public_key.data.data[:, :k], t.q, t.ratio_lo, t.ratio_hi)     # (size, k, n)
    if not is_ntt_form:
        c = NTT.inverse(c, t)
    if parms.scheme == SchemeType.BGV:
        noise = _times_t(NTT.forward(noise, t, lazy=True) if is_ntt_form else noise, parms, moduli, t)
    elif is_ntt_form:
        noise = NTT.forward(noise, t)
    return Ciphertext(U.add_mod(noise, c, t.q), parms_id, is_ntt_form, 1.0, 1)
