"""The port's device sampling against the JAX package and the host stream.

(a) ``seal_tpu_torch/ops/blake2_dev.py``'s plain versions (what a CPU
    tensor runs; kernels C and D take their place on the card) against
    ``seal_tpu.ops.blake2_dev`` and the host ``Blake2xbPRNG`` stream and
    samplers, on seeds from numpy with words of 2^63 and more: the stream
    at 1, 511, 513 and 1,500 words across buffer boundaries; CBD noise from
    an offset that is not a multiple of 8; the uniform sampler at moduli
    that reject rarely, often (the fix-up and the limb-to-limb offset
    chaining run) and both, with the overflow flags; ``lift_signed``; the
    overflow flags again with tail windows cut short on both sides;
(b) keygen and symmetric encryption on the device path against the host
    path (``SEAL_TPU_DEVICE_SAMPLING=0``) and against the JAX package's
    ``KeyGenerator`` and ``encrypt_zero_symmetric`` (on its host path, which
    ``tests/test_blake2_dev.py`` holds equal to its device path; compiling
    the latter would add ~30 s a scheme), for CKKS, BFV (coefficient form, with and without a saved seed) and
    BGV (t e) at N=256 with a seeded BLAKE2XB factory: the public,
    relinearization and Galois keys with their seeds, and an encryption
    from a bootstrap PRNG resumed at a position that is not a multiple of
    8; and, against the host path, the same with a factory that hands out
    a distinct seed per draw, so that a key's D rows come from D different
    streams, each c1 row the expansion of its own seed;
(c) the conditions of the host path: the switch set to ``"0"`` or ``""``,
    a SHAKE-256 factory, Gaussian noise; and a tail-window overflow at
    moduli near 3 * 2^58 (one word in 64 rejected), which takes the host
    path, gives its bytes and counts in ``rlwe.host_fallbacks``; at the
    same moduli without the cut the device path's fix-up gives the host's
    bytes.

Every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax

from seal_tpu.context import SealContext as JaxContext
from seal_tpu.encryptor import Encryptor as JaxEncryptor
from seal_tpu.keygen import KeyGenerator as JaxKeyGenerator
from seal_tpu.modulus import (CoeffModulus as JaxCoeffModulus, PlainModulus as JaxPlainModulus,
                              SecurityLevel as JaxSecurityLevel)
from seal_tpu.ops import blake2_dev as JB
from seal_tpu.ops import u64 as JU
from seal_tpu.params import EncryptionParameters as JaxParameters, SchemeType as JaxScheme
from seal_tpu.random import PRNGType as JaxPRNGType, UniformRandomGeneratorFactory as JaxFactory
from seal_tpu.rlwe import encrypt_zero_symmetric as jax_encrypt_zero_symmetric

import seal_tpu_torch as P
from seal_tpu_torch import convert as C
from seal_tpu_torch import numth, rlwe
from seal_tpu_torch.ops import blake2_dev as B
from seal_tpu_torch.random.prng import Blake2xbPRNG
from seal_tpu_torch.random.sampler import sample_poly_cbd, sample_poly_uniform

SEEDS = np.random.default_rng(2026).integers(0, 1 << 64, size=(3, 8), dtype=np.uint64)
N_SAMPLER = 512


def _prime_near(x, two_n):
    c = x - (x % two_n) + 1
    while not numth.is_prime(c):
        c -= two_n
    return c


# the JAX test's three moduli sets (tests/test_blake2_dev.py:60-79)
MODULI = {
    "default61": lambda: tuple(numth.get_primes(2 * 4096, 61, 3)),
    "high_rejection": lambda: (_prime_near(3 << 60, 2 * N_SAMPLER),
                               _prime_near((3 << 60) - (1 << 55), 2 * N_SAMPLER)),
    "mixed": lambda: (_prime_near((1 << 30) + (1 << 29), 2 * N_SAMPLER), _prime_near(3 << 60, 2 * N_SAMPLER)),
}


def _seeds():
    return C.u64_from_numpy(SEEDS, "cpu")


def _host_prng(i):
    return Blake2xbPRNG(tuple(int(w) for w in SEEDS[i]))


def test_seeds_hold_words_of_2_63_and_more():
    assert (SEEDS >= np.uint64(1 << 63)).any() and (SEEDS < np.uint64(1 << 63)).any()


# -- (a) the plain versions ----------------------------------------------------------

@pytest.mark.parametrize("nwords", [1, 511, 513, 1500])
def test_expand_stream_words_equals_jax_and_the_host_stream(nwords):
    got = C.u64_to_numpy(B.expand_stream_words(_seeds(), nwords))
    jax_words = JU.to_np_u64(jax.jit(lambda s: JB.expand_stream_words(s, nwords))(JU.from_np_u64(SEEDS)))
    np.testing.assert_array_equal(got, jax_words)
    for i in range(len(SEEDS)):
        np.testing.assert_array_equal(got[i], np.frombuffer(_host_prng(i).generate(8 * nwords), dtype="<u8"))


def test_expand_stream_words_in_chunks_equals_one_pass():
    assert torch.equal(B.expand_stream_words(_seeds(), 1500, chunk_buffers=1), B.expand_stream_words(_seeds(), 1500))


@pytest.mark.parametrize("skip_bytes", [64, 67])
def test_cbd_noise_equals_jax_and_the_host_sampler(skip_bytes):
    n, moduli = N_SAMPLER, [97, (1 << 40) + 1]
    words = B.expand_stream_words(_seeds(), (skip_bytes + 6 * n + 7) // 8)
    noise = B.cbd_noise_from_words(words, n, skip_bytes=skip_bytes)
    jwords = JB.expand_stream_words(JU.from_np_u64(SEEDS), (skip_bytes + 6 * n + 7) // 8)
    np.testing.assert_array_equal(noise.numpy(), np.asarray(JB.cbd_noise_from_words(jwords, n, skip_bytes)))
    lifted = C.u64_to_numpy(B.cbd_lifted(words, n, moduli, skip_bytes=skip_bytes))
    for i in range(len(SEEDS)):
        prng = _host_prng(i)
        prng.generate(skip_bytes)
        np.testing.assert_array_equal(lifted[i], sample_poly_cbd(prng, n, moduli))


@pytest.mark.parametrize("kind", list(MODULI))
def test_uniform_from_seed_words_equals_jax_and_the_host_sampler(kind):
    moduli = MODULI[kind]()
    vals, overflow = B.uniform_from_seed_words(_seeds(), N_SAMPLER, moduli)
    jvals, jover = jax.jit(lambda s: JB.uniform_from_seed_words(s, N_SAMPLER, moduli))(JU.from_np_u64(SEEDS))
    np.testing.assert_array_equal(overflow.numpy(), np.asarray(jover))
    assert not overflow.any()
    got = C.u64_to_numpy(vals)
    np.testing.assert_array_equal(got, JU.to_np_u64(jvals))
    for i in range(len(SEEDS)):
        np.testing.assert_array_equal(got[i], sample_poly_uniform(_host_prng(i), N_SAMPLER, moduli))
    _, counts = B.uniform_bulk(B.expand_stream_words(_seeds(), len(moduli) * N_SAMPLER), N_SAMPLER, moduli)
    assert bool((counts > 0).any()) == (kind != "default61")        # the fix-up ran where words were rejected


def test_uniform_overflow_flags_equal_jax_with_short_windows(monkeypatch):
    """Windows of 4 words against ~32 rejections a limb: every stream
    overflows, and the flags and (meaningless) values equal the JAX
    package's under the same cut."""
    moduli = MODULI["high_rejection"]()
    short = lambda n, mods: ([4] * len(mods), 4 * len(mods))
    monkeypatch.setattr(B, "uniform_tail_words", short)
    monkeypatch.setattr(JB, "uniform_tail_words", short)
    vals, overflow = B.uniform_from_seed_words(_seeds(), N_SAMPLER, moduli)
    jvals, jover = JB.uniform_from_seed_words(JU.from_np_u64(SEEDS), N_SAMPLER, moduli)
    assert overflow.all()
    np.testing.assert_array_equal(overflow.numpy(), np.asarray(jover))
    np.testing.assert_array_equal(C.u64_to_numpy(vals), JU.to_np_u64(jvals))


def test_lift_signed_equals_jax():
    vals = np.array([[0, 1, -1, 24, -24], [3, -3, 0, -7, 7]], dtype=np.int32)
    moduli = [97, 193, (1 << 60) - 93]
    got = C.u64_to_numpy(B.lift_signed(torch.from_numpy(vals.astype(np.int64)), moduli))
    np.testing.assert_array_equal(got, JU.to_np_u64(JB.lift_signed(vals, moduli)))


def test_bytes_round_trip_the_words():
    words = _seeds()
    assert torch.equal(B.bytes_to_words(B.words_to_bytes(words)), words)
    np.testing.assert_array_equal(B.words_to_bytes(words).numpy().astype(np.uint8),
                                  SEEDS.view(np.uint8).reshape(3, 64))


# -- (b) keygen and symmetric encryption -----------------------------------------------

N = 256
BITS = [50, 40, 50]
SEED = (5, 6, 7, 8, 9, 10, 11, 12)
SCHEMES = {"ckks": (P.SchemeType.CKKS, JaxScheme.CKKS), "bfv": (P.SchemeType.BFV, JaxScheme.BFV),
           "bgv": (P.SchemeType.BGV, JaxScheme.BGV)}


def _port_context(scheme, moduli=None, factory=None, noise_sampler="cbd"):
    parms = P.EncryptionParameters(scheme)
    parms.set_poly_modulus_degree(N)
    parms.set_noise_sampler(noise_sampler)
    parms.set_coeff_modulus(moduli or P.CoeffModulus.create(N, BITS))
    if scheme != P.SchemeType.CKKS:
        parms.set_plain_modulus(P.PlainModulus.batching(N, 17))
    parms.set_random_generator(factory or P.UniformRandomGeneratorFactory(P.PRNGType.BLAKE2XB, SEED))
    return P.SealContext(parms, True, P.SecurityLevel.NONE, device="cpu")


def _jax_context(scheme):
    parms = JaxParameters(scheme)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(JaxCoeffModulus.create(N, BITS))
    if scheme != JaxScheme.CKKS:
        parms.set_plain_modulus(JaxPlainModulus.batching(N, 17))
    parms.set_random_generator(JaxFactory(JaxPRNGType.BLAKE2XB, SEED))
    return JaxContext(parms, True, JaxSecurityLevel.NONE)


def _objects(ctx, kg, enc, encrypt_zero, to_np):
    """Every sampled object of a client, as numpy, with its seeds."""
    out = {}
    for save_seed in (False, True):
        rk = kg.create_relin_keys(save_seed=save_seed).keys[0]
        out[f"relin key, save_seed {save_seed}"] = (to_np(rk["c0"]), to_np(rk["c1"]),
                                                     [s.seed for s in rk["seeds"]] if save_seed else None)
        ct = enc.encrypt_zero_symmetric(save_seed=save_seed)
        out[f"encrypt_zero_symmetric, save_seed {save_seed}"] = (
            to_np(ct.data), ct.seed_info.seed if save_seed else None)
    gk = kg.create_galois_keys_from_steps([1])
    out["galois keys"] = [(i, to_np(k["c0"]), to_np(k["c1"])) for i, k in enumerate(gk.keys) if k is not None]
    pk = kg.create_public_key(save_seed=True)
    out["public key"] = (to_np(pk.data.data), pk.data.seed_info.seed)
    # a bootstrap stream resumed 13 bytes in
    prng = ctx.key_context_data().parms.random_generator.create()
    prng.generate(13)
    ct = encrypt_zero(kg.secret_key, ctx, ctx.first_parms_id, ctx.first_context_data().parms.scheme
                      in (P.SchemeType.CKKS, P.SchemeType.BGV, JaxScheme.CKKS, JaxScheme.BGV), True, prng)
    out["bootstrap resumed at byte 13"] = (to_np(ct.data), ct.seed_info.seed, prng._pos)
    return out


@pytest.fixture(scope="module", params=list(SCHEMES))
def sides(request):
    """One client per side: the port's device path (counting the stream's
    expansions), the port's host path, and the JAX package."""
    scheme, jscheme = SCHEMES[request.param]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAL_TPU_DEVICE_SAMPLING", "0")
        jctx = _jax_context(jscheme)
        jkg = JaxKeyGenerator(jctx)
        jax_side = _objects(jctx, jkg, JaxEncryptor(jctx, secret_key=jkg.secret_key), jax_encrypt_zero_symmetric,
                            JU.to_np_u64)
        mp.setenv("SEAL_TPU_DEVICE_SAMPLING", "1")
        ctx = _port_context(scheme)
        kg = P.KeyGenerator(ctx)
        np.testing.assert_array_equal(C.u64_to_numpy(kg.secret_key.data), JU.to_np_u64(jkg.secret_key.data))
        calls = {"n": 0}
        expand = B.expand_stream_words

        def counted(*args, **kwargs):
            calls["n"] += 1
            return expand(*args, **kwargs)

        mp.setattr(B, "expand_stream_words", counted)
        before = rlwe.host_fallbacks
        device = _objects(ctx, kg, P.Encryptor(ctx, secret_key=kg.secret_key), rlwe.encrypt_zero_symmetric,
                          C.u64_to_numpy)
        assert rlwe.host_fallbacks == before and calls["n"] > 0
        mp.setenv("SEAL_TPU_DEVICE_SAMPLING", "0")
        calls["n"] = 0
        host = _objects(ctx, kg, P.Encryptor(ctx, secret_key=kg.secret_key), rlwe.encrypt_zero_symmetric,
                        C.u64_to_numpy)
        assert calls["n"] == 0
    return device, host, jax_side


def _assert_same(a, b):
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


OBJECTS = ["relin key, save_seed False", "relin key, save_seed True", "encrypt_zero_symmetric, save_seed False",
           "encrypt_zero_symmetric, save_seed True", "galois keys", "public key", "bootstrap resumed at byte 13"]


@pytest.mark.parametrize("name", OBJECTS)
def test_device_path_equals_host_path_and_jax(sides, name):
    device, host, jax_side = sides
    _assert_same(device[name], host[name])
    _assert_same(device[name], jax_side[name])


class _FreshSeeds(P.UniformRandomGeneratorFactory):
    """A BLAKE2XB factory whose create() draws a new seed at each call from
    seeded numpy; restart() replays the draws, so that the device and the
    host path get the same seeds in the same order."""

    def __init__(self, seed):
        super().__init__(P.PRNGType.BLAKE2XB)
        self.seed = seed
        self.restart()

    def restart(self):
        self.rng = np.random.default_rng(self.seed)

    def create(self, seed=None):
        if seed is None:
            seed = tuple(int(w) for w in self.rng.integers(0, 1 << 64, size=8, dtype=np.uint64))
        return super().create(seed)


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_keys_from_distinct_seeds_equal_the_host_path(monkeypatch, scheme):
    """With a fixed-seed factory a key's D bootstrap streams are all equal,
    so a row of the batched draw taken from another stream than its noise
    or its seed would not show; here every draw has its own seed, D = 4,
    and c1's row i is the expansion of the key's seeds[i]."""
    factory = _FreshSeeds(2027)
    ctx = _port_context(SCHEMES[scheme][0], moduli=P.CoeffModulus.create(N, [50, 40, 40, 40, 50]), factory=factory)
    key_moduli = ctx.key_context_data().coeff_modulus_values

    def client():
        factory.restart()
        kg = P.KeyGenerator(ctx)
        rk = kg.create_relin_keys(save_seed=True).keys[0]
        rk_full = kg.create_relin_keys().keys[0]
        gk = [k for k in kg.create_galois_keys_from_steps([1]).keys if k is not None]
        pk = kg.create_public_key(save_seed=True)
        ct = P.Encryptor(ctx, secret_key=kg.secret_key).encrypt_zero_symmetric(save_seed=True)
        return ([rk["c0"], rk["c1"], rk_full["c0"], rk_full["c1"], pk.data.data, ct.data]
                + [k[part] for k in gk for part in ("c0", "c1")]), \
            [s.seed for s in rk["seeds"]] + [pk.data.seed_info.seed, ct.seed_info.seed]

    monkeypatch.setenv("SEAL_TPU_DEVICE_SAMPLING", "0")
    want, want_seeds = client()
    monkeypatch.setenv("SEAL_TPU_DEVICE_SAMPLING", "1")
    calls = {"n": 0}
    expand = B.expand_stream_words

    def counted(*args, **kwargs):
        calls["n"] += 1
        return expand(*args, **kwargs)

    monkeypatch.setattr(B, "expand_stream_words", counted)
    before = rlwe.host_fallbacks
    got, got_seeds = client()
    assert calls["n"] > 0 and rlwe.host_fallbacks == before
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got_seeds == want_seeds and len(set(got_seeds)) == len(got_seeds)
    c1 = C.u64_to_numpy(got[1])
    assert c1.shape[0] == 4
    for i, seed in enumerate(got_seeds[:4]):
        np.testing.assert_array_equal(c1[i], sample_poly_uniform(Blake2xbPRNG(seed), N, key_moduli))


# -- (c) the host path's conditions and the overflow -----------------------------------

def _raise(*args, **kwargs):
    raise AssertionError("the device sampler ran")


@pytest.mark.parametrize("switch", ["0", ""])
def test_switch_off_takes_the_host_path(monkeypatch, switch):
    ctx = _port_context(P.SchemeType.BFV)
    kg = P.KeyGenerator(ctx)
    want_rk = kg.create_relin_keys(save_seed=True).keys[0]
    want_ct = P.Encryptor(ctx, secret_key=kg.secret_key).encrypt_zero_symmetric(save_seed=True)
    monkeypatch.setenv("SEAL_TPU_DEVICE_SAMPLING", switch)
    monkeypatch.setattr(B, "expand_stream_words", _raise)
    rk = kg.create_relin_keys(save_seed=True).keys[0]
    ct = P.Encryptor(ctx, secret_key=kg.secret_key).encrypt_zero_symmetric(save_seed=True)
    assert torch.equal(rk["c0"], want_rk["c0"]) and torch.equal(rk["c1"], want_rk["c1"])
    assert rk["seeds"] == want_rk["seeds"]
    assert torch.equal(ct.data, want_ct.data) and ct.seed_info == want_ct.seed_info


def test_shake256_and_gaussian_take_the_host_path(monkeypatch):
    monkeypatch.setenv("SEAL_TPU_DEVICE_SAMPLING", "1")
    monkeypatch.setattr(B, "expand_stream_words", _raise)
    shake = _port_context(P.SchemeType.CKKS, factory=P.UniformRandomGeneratorFactory(P.PRNGType.SHAKE256, SEED))
    kg = P.KeyGenerator(shake)
    kg.create_relin_keys()
    P.Encryptor(shake, secret_key=kg.secret_key).encrypt_zero_symmetric()
    gaussian = _port_context(P.SchemeType.CKKS, noise_sampler="gaussian")
    kg = P.KeyGenerator(gaussian)
    kg.create_relin_keys()
    P.Encryptor(gaussian, secret_key=kg.secret_key).encrypt_zero_symmetric()


def _rejecting_context():
    """Three 60-bit moduli near 3 * 2^58: one uniform word in 64 rejected.
    Two limbs at the first level: with one, the JAX package's window rule
    (a limb's redraws must leave the other limbs' windows free) counts any
    rejection as an overflow."""
    moduli = [P.Modulus(_prime_near((3 << 58) - (i << 50), 2 * N)) for i in range(3)]
    assert all(B.uniform_reject_prob(m.value) > 1 / 70 for m in moduli)
    return _port_context(P.SchemeType.BGV, moduli=moduli)


def _client(ctx, kg):
    rk = kg.create_relin_keys(save_seed=True).keys[0]
    ct = P.Encryptor(ctx, secret_key=kg.secret_key).encrypt_zero_symmetric(save_seed=True)
    return [rk["c0"], rk["c1"], ct.data], [rk["seeds"], ct.seed_info]


@pytest.mark.parametrize("cut", [False, True])
def test_frequent_rejections_give_the_host_bytes(monkeypatch, cut):
    """Without the cut the fix-up runs inside keygen and encryption; with
    windows of 2 words every draw overflows and takes the host path."""
    ctx = _rejecting_context()
    kg = P.KeyGenerator(ctx)
    monkeypatch.setenv("SEAL_TPU_DEVICE_SAMPLING", "0")
    want, want_seeds = _client(ctx, kg)
    monkeypatch.setenv("SEAL_TPU_DEVICE_SAMPLING", "1")
    if cut:
        monkeypatch.setattr(B, "uniform_tail_words", lambda n, mods: ([2] * len(mods), 2 * len(mods)))
    before = rlwe.host_fallbacks
    got, got_seeds = _client(ctx, kg)
    # with the cut: the key's batched draw, then each of its D = 2 host-path
    # encryptions (which try the device first, as the JAX package's do), and
    # the encryption
    assert rlwe.host_fallbacks - before == (4 if cut else 0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got_seeds == want_seeds
