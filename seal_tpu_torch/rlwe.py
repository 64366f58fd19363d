"""RLWE encryptions of zero: the core of keygen and encryption.

Port of ``seal_tpu/rlwe.py`` (counterpart of ``util/rlwe.cpp:190-407``): in
NTT form for keys, CKKS and BGV ciphertexts, in coefficient form for BFV
ciphertexts (``is_ntt_form=False``); BGV's noise is t times the sampled
one.  A symmetric encryption samples on the context's device by default,
as the JAX package does: the BLAKE2xb stream, the uniform a and the CBD
noise through ``ops/blake2_dev.py`` (kernels C and D on the card), with
only the 64-byte bootstrap seed leaving the host
(:func:`_encrypt_zero_symmetric_device`).  The host samplers (numpy over
the PRNG byte stream, in the reference's draw order) serve a PRNG that is
not BLAKE2xb, Gaussian noise, ``SEAL_TPU_DEVICE_SAMPLING`` set to ``""`` or
``"0"``, and a rejection-tail overflow, counted in :data:`host_fallbacks`;
both give the same bytes.  Public-key encryption samples on the host, as
in the JAX package.  The ring arithmetic runs on the context's device,
every NTT through ``ops/ntt.py``.
"""

from __future__ import annotations

import os
import struct

import torch

from .context import SealContext
from .data import Ciphertext, PublicKey, SecretKey
from .ntt_tables import u64_tensor
from .params import ParmsId, SchemeType
from .ops import blake2_dev as B
from .ops import ntt as NTT
from .ops import u64 as U
from .ops.rns import _cshoup
from .random import UniformRandomGeneratorFactory, UniformRandomGeneratorInfo
from .random.prng import PRNG_SEED_BYTE_COUNT, Blake2xbPRNG, PRNGType
from .random.sampler import noise_sampler_for, sample_poly_ternary, sample_poly_uniform

# Device-sampled draws redone on the host after a rejection-tail overflow
# (keygen's too): the same bytes, so a matter of time, never of result.
host_fallbacks = 0


def device_sampling(parms, bootstrap_prng=None) -> bool:
    """Whether symmetric encryption and keygen sample on the device, on the
    JAX package's conditions: the switch (``SEAL_TPU_DEVICE_SAMPLING``,
    read at each call) not ``""`` or ``"0"``, CBD noise, and BLAKE2xb
    bootstrap streams (``bootstrap_prng`` a :class:`Blake2xbPRNG`, or by
    default the parameters' factory of that type)."""
    if bootstrap_prng is None:
        blake2xb = parms.random_generator.prng_type == PRNGType.BLAKE2XB
    else:
        blake2xb = isinstance(bootstrap_prng, Blake2xbPRNG)
    return (blake2xb and parms.noise_sampler == "cbd"
            and os.environ.get("SEAL_TPU_DEVICE_SAMPLING", "1") not in ("", "0"))


def device_samples(seeds: torch.Tensor, pos: int, n: int, moduli):
    """The samples of S encryptions of zero from S bootstrap streams
    resumed at byte ``pos`` (``seeds``: (S, 8) int64 on the device): the
    public seeds (S, 8), the uniform a (S, k, n) they expand to, and the
    lifted CBD noise (S, k, n) after them; None after a rejection-tail
    overflow, counted in :data:`host_fallbacks`."""
    global host_fallbacks
    boot = B.expand_stream_words(seeds, (pos + 64 + 6 * n + 7) // 8)
    public = B.bytes_to_words(B.words_to_bytes(boot[:, : (pos + 64 + 7) // 8])[:, pos: pos + 64])
    noise = B.cbd_lifted(boot, n, moduli, skip_bytes=pos + 64)
    a, overflow = B.uniform_from_seed_words(public, n, moduli)
    if bool(overflow.any()):
        host_fallbacks += 1
        return None
    return public, a, noise


def seed_infos(public_seeds: torch.Tensor) -> list:
    """(S, 8) public seeds -> their S ``UniformRandomGeneratorInfo``."""
    words = public_seeds.cpu().numpy().view("uint64")
    return [UniformRandomGeneratorInfo(PRNGType.BLAKE2XB, tuple(int(w) for w in row)) for row in words]


def _times_t(noise: torch.Tensor, parms, moduli, t) -> torch.Tensor:
    """BGV's noise t e mod q_i, for any 64-bit e (a lazy NTT's output too)."""
    tv = parms.plain_modulus.value
    return U.mul_mod_shoup(noise, *_cshoup([tv % q for q in moduli], moduli, noise.device), t.q)


def zero_encryption(sk: torch.Tensor, a: torch.Tensor, noise: torch.Tensor, parms, moduli, t,
                    is_ntt_form: bool, save_seed: bool):
    """(c0, c1) of an encryption of zero from its samples, for any leading
    batch: ``a`` (..., k, n) the uniform sample, ``noise`` (..., k, n) the
    lifted noise, ``sk`` (k', n) the NTT-form secret key, k' >= k.

    The uniform sample is a's NTT form, except in coefficient form with
    ``save_seed``, where it is a itself (what the seed regenerates).
    """
    a_ntt = NTT.forward(a, t) if save_seed and not is_ntt_form else a
    c0 = U.mul_mod(sk[: len(moduli)], a_ntt, t.q, t.ratio_lo, t.ratio_hi)
    c1 = a
    if is_ntt_form:
        noise = NTT.forward(noise, t)
    else:
        c0 = NTT.inverse(c0, t)
        if not save_seed:
            c1 = NTT.inverse(a, t)
    if parms.scheme == SchemeType.BGV:
        noise = _times_t(noise, parms, moduli, t)
    return U.neg_mod(U.add_mod(noise, c0, t.q), t.q), c1


def encrypt_zero_symmetric(secret_key: SecretKey, context: SealContext, parms_id: ParmsId,
                           is_ntt_form: bool, save_seed: bool = False, bootstrap_prng=None) -> Ciphertext:
    """(c0, c1) = ([-(a s + e)]_q, a) (BGV: t e), in NTT form or in
    coefficient form (rlwe.cpp:277-407).

    ``a`` is expanded from a public seed drawn from ``bootstrap_prng`` (by
    default a fresh one from the parameters' factory), and the noise from
    the bootstrap stream after it; with ``save_seed`` the public seed is
    kept in ``seed_info`` so c1 can be regenerated.
    """
    cd = context.get_context_data(parms_id)
    parms = cd.parms
    if bootstrap_prng is None:
        bootstrap_prng = parms.random_generator.create()
    ct = _encrypt_zero_symmetric_device(secret_key, context, parms_id, is_ntt_form, save_seed, bootstrap_prng)
    if ct is not None:
        return ct

    moduli = cd.coeff_modulus_values
    n = parms.poly_modulus_degree
    dev = context.device
    public_seed = struct.unpack("<8Q", bootstrap_prng.generate(PRNG_SEED_BYTE_COUNT))
    ciphertext_prng = UniformRandomGeneratorFactory.default_factory().create(public_seed)
    a = u64_tensor(sample_poly_uniform(ciphertext_prng, n, moduli), dev)
    noise = u64_tensor(noise_sampler_for(parms)(bootstrap_prng, n, moduli), dev)
    c0, c1 = zero_encryption(secret_key.data, a, noise, parms, moduli, cd.limb_tables(), is_ntt_form, save_seed)
    ct = Ciphertext(torch.stack([c0, c1]), parms_id, is_ntt_form, 1.0, 1)
    if save_seed:
        ct.seed_info = ciphertext_prng.info()
    return ct


def _encrypt_zero_symmetric_device(secret_key: SecretKey, context: SealContext, parms_id: ParmsId,
                                   is_ntt_form: bool, save_seed: bool, bootstrap_prng):
    """The device-sampled encryption of zero (``seal_tpu/rlwe.py:138-236``),
    byte-identical to the host path, or None where the host path serves:
    a PRNG that is not BLAKE2xb, Gaussian noise, the switch off, or a
    rejection-tail overflow (counted in :data:`host_fallbacks`).

    The bootstrap stream is resumed at ``bootstrap_prng._pos``: the public
    seed is its bytes [pos, pos + 64), the noise the 6 n bytes after, and
    the position then advances as if the host had drawn them.
    """
    cd = context.get_context_data(parms_id)
    parms = cd.parms
    if not device_sampling(parms, bootstrap_prng):
        return None
    moduli = cd.coeff_modulus_values
    n = parms.poly_modulus_degree
    pos = bootstrap_prng._pos
    samples = device_samples(u64_tensor([bootstrap_prng.seed], context.device), pos, n, moduli)
    if samples is None:
        return None
    public, a, noise = samples
    bootstrap_prng._pos = pos + 64 + 6 * n
    c0, c1 = zero_encryption(secret_key.data, a[0], noise[0], parms, moduli, cd.limb_tables(), is_ntt_form,
                             save_seed)
    ct = Ciphertext(torch.stack([c0, c1]), parms_id, is_ntt_form, 1.0, 1)
    if save_seed:
        ct.seed_info = seed_infos(public)[0]
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
