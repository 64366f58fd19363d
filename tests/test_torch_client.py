"""The port's client side against the JAX package, byte for byte.

CKKS N=1024, bits [60, 40, 40, 40, 60], ``SecurityLevel.NONE``, with the
seeded BLAKE2XB factory of ``__graft_entry__._build``:

(a) the PRNG streams (BLAKE2xb and SHAKE-256, read in uneven pieces) and
    the samplers (ternary, CBD, clipped normal, uniform with rejection);
(b) the secret, public and relinearization keys;
(c) ``encrypt_symmetric`` (with and without a saved seed) and ``encrypt``;
(d) ``decrypt``;
(e) ``encode`` (vector, short vector, real and complex scalar, and the wide
    tier above 2^53) and ``decode``, against the JAX package's host ladder
    (``SEAL_TPU_DEVICE_FFT=0``, ``SEAL_TPU_DEVICE_COMPOSE=0``);
(f) the numpy round trips of ``convert``, and what the port refuses;
(g) the whole computation: encode, encrypt with the secret and with the
    public key, multiply, relinearize, rescale, decrypt and decode.

The JAX side samples on the host (``SEAL_TPU_DEVICE_SAMPLING=0``), the path
the port implements; the JAX package's own tests hold its device sampling
to the same bytes.  The JAX package's answers to (b) to (e) and (g) are
frozen in ``tests/data/jax_answers/`` (``tests/jax_answers.py``); the test
marked ``slow`` recomputes them.  Every comparison is exact: integers are
equal, and the decoded float64 values are equal bit for bit, no tolerance.
"""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from seal_tpu.ckks_encoder import CKKSEncoder as JaxEncoder
from seal_tpu.context import SealContext as JaxContext
from seal_tpu.decryptor import Decryptor as JaxDecryptor
from seal_tpu.encryptor import Encryptor as JaxEncryptor
from seal_tpu.evaluator import Evaluator as JaxEvaluator
from seal_tpu.keygen import KeyGenerator as JaxKeyGenerator
from seal_tpu.modulus import CoeffModulus as JaxCoeffModulus, SecurityLevel as JaxSecurityLevel
from seal_tpu.native import blake2xb as jax_blake2xb
from seal_tpu.params import EncryptionParameters as JaxParameters, SchemeType as JaxScheme
from seal_tpu.random import PRNGType as JaxPRNGType, UniformRandomGeneratorFactory as JaxFactory
from seal_tpu.random import sampler as JS

import seal_tpu_torch as P
from seal_tpu_torch import convert as C
from seal_tpu_torch.random import prng as PP
from seal_tpu_torch.random import sampler as PS

import jax_answers as JA

N = 1024
BITS = [60, 40, 40, 40, 60]
SEED = (1, 2, 3, 4, 5, 6, 7, 8)      # __graft_entry__._build's factory seed


ANSWERS = JA.Answers(__file__)


def _package(side):
    if side == "jax":
        return SimpleNamespace(Parameters=JaxParameters, Scheme=JaxScheme, CoeffModulus=JaxCoeffModulus,
                               Context=lambda parms: JaxContext(parms, True, JaxSecurityLevel.NONE),
                               Factory=JaxFactory, PRNGType=JaxPRNGType, KeyGenerator=JaxKeyGenerator,
                               Encoder=JaxEncoder, Encryptor=JaxEncryptor, Decryptor=JaxDecryptor,
                               Evaluator=JaxEvaluator)
    return SimpleNamespace(Parameters=P.EncryptionParameters, Scheme=P.SchemeType, CoeffModulus=P.CoeffModulus,
                           Context=lambda parms: P.SealContext(parms, True, P.SecurityLevel.NONE, device="cpu"),
                           Factory=P.UniformRandomGeneratorFactory, PRNGType=P.PRNGType, KeyGenerator=P.KeyGenerator,
                           Encoder=P.CKKSEncoder, Encryptor=P.Encryptor, Decryptor=P.Decryptor, Evaluator=P.Evaluator)


@contextlib.contextmanager
def _host_paths():
    """Host sampling and the host ladder, the paths the port implements."""
    with pytest.MonkeyPatch.context() as mp:
        for var in ("SEAL_TPU_DEVICE_SAMPLING", "SEAL_TPU_DEVICE_FFT", "SEAL_TPU_DEVICE_COMPOSE"):
            mp.setenv(var, "0")
        yield


def _client(side):
    """One package's context, keys and classes from the seeded factory."""
    k = _package(side)
    with _host_paths():
        parms = k.Parameters(k.Scheme.CKKS)
        parms.set_poly_modulus_degree(N)
        parms.set_coeff_modulus(k.CoeffModulus.create(N, BITS))
        parms.set_random_generator(k.Factory(k.PRNGType.BLAKE2XB, SEED))
        ctx = k.Context(parms)
        kg = k.KeyGenerator(ctx)
        return {"side": side, "k": k, "ctx": ctx, "kg": kg, "sk": kg.secret_key, "pk": kg.create_public_key(),
                "rk": kg.create_relin_keys(), "plain": k.Encoder(ctx).encode(ENCODED, 2.0 ** 40)}


@pytest.fixture(scope="module")
def pair():
    """The port's side, built by its own client."""
    return _client("port")


# -- (a) PRNG streams and samplers ------------------------------------------

def test_blake2xb_matches_jax_native():
    key = bytes((i * 7 + 1) & 0xFF for i in range(64))
    for outlen in (1, 64, 65, 4096, 5000):
        assert PP.blake2xb(outlen, b"\x2a" * 8, key) == jax_blake2xb(outlen, b"\x2a" * 8, key)


@pytest.mark.parametrize("prng_type", [JaxPRNGType.BLAKE2XB, JaxPRNGType.SHAKE256])
def test_prng_streams_match_jax(prng_type):
    jg = JaxFactory(prng_type, SEED).create()
    pg = P.UniformRandomGeneratorFactory(P.PRNGType(int(prng_type)), SEED).create()
    for size in (10, 4086, 1, 9000, 3):
        assert pg.generate(size) == jg.generate(size)
    assert pg.info() == PP.UniformRandomGeneratorInfo(P.PRNGType(int(prng_type)), SEED)


@pytest.mark.parametrize("name", ["sample_poly_ternary", "sample_poly_cbd", "sample_poly_normal",
                                  "sample_poly_uniform"])
def test_samplers_match_jax(name):
    moduli = [m.value for m in P.CoeffModulus.create(N, BITS)]
    jg = JaxFactory(JaxPRNGType.BLAKE2XB, SEED).create()
    pg = P.UniformRandomGeneratorFactory(P.PRNGType.BLAKE2XB, SEED).create()
    for _ in range(2):                               # the second draw starts mid-stream
        np.testing.assert_array_equal(getattr(PS, name)(pg, N, moduli), getattr(JS, name)(jg, N, moduli))


def test_uniform_sampler_rejection_redraws_like_jax():
    """A modulus just above 2^63 rejects about half the words."""
    q = (1 << 63) + 29
    jg = JaxFactory(JaxPRNGType.BLAKE2XB, SEED).create()
    pg = P.UniformRandomGeneratorFactory(P.PRNGType.BLAKE2XB, SEED).create()
    np.testing.assert_array_equal(PS.sample_poly_uniform(pg, 64, [q]), JS.sample_poly_uniform(jg, 64, [q]))
    assert pg.generate(16) == jg.generate(16)


# -- (b) keys ----------------------------------------------------------------

SEEDS = {"seed": np.array(SEED, dtype=np.uint64)}


def test_secret_key_matches_jax(pair, request):
    ANSWERS.check(request.node.name, SEEDS, {"secret_key": pair["sk"]})


def test_public_key_matches_jax(pair, request):
    ANSWERS.check(request.node.name, SEEDS, {"public_key": pair["pk"]})


def test_relin_keys_match_jax(pair, request):
    ANSWERS.check(request.node.name, SEEDS, {"relin_keys": pair["rk"]})


def _cube_case(c):
    """count=2 adds the key for s^3 (the secret-key power cache)."""
    with _host_paths():
        return SEEDS, {"relin_keys(count=2)": c["kg"].create_relin_keys(count=2)}


def test_relin_key_for_a_cube_matches_jax(pair, request):
    ANSWERS.check(request.node.name, *_cube_case(pair))


# -- (c, d) encryption and decryption ---------------------------------------

ENCODED = np.linspace(-1.0, 1.0, N // 2) + 0.5j * np.linspace(0.3, -0.7, N // 2)


def _symmetric_case(c, save_seed):
    with _host_paths():
        ct = c["k"].Encryptor(c["ctx"], secret_key=c["sk"]).encrypt_symmetric(c["plain"], save_seed=save_seed)
    outs = {"ciphertext": ct}
    if save_seed:
        outs["seed"] = np.array(ct.seed_info.seed, dtype=np.uint64)
        outs["prng_type"] = int(ct.seed_info.prng_type)
    return {"plain": c["plain"], "secret_key": c["sk"]}, outs


@pytest.mark.parametrize("save_seed", [False, True])
def test_encrypt_symmetric_matches_jax(pair, save_seed, request):
    ANSWERS.check(request.node.name, *_symmetric_case(pair, save_seed))


def _public_case(c):
    with _host_paths():
        ct = c["k"].Encryptor(c["ctx"], public_key=c["pk"]).encrypt(c["plain"])
    return {"plain": c["plain"], "public_key": c["pk"]}, {"ciphertext": ct}


def test_encrypt_with_public_key_matches_jax(pair, request):
    ANSWERS.check(request.node.name, *_public_case(pair))


def _decrypt_case(c):
    with _host_paths():
        ct = c["k"].Encryptor(c["ctx"], secret_key=c["sk"]).encrypt_symmetric(c["plain"])
    return {"ciphertext": ct}, {"plain": c["k"].Decryptor(c["ctx"], c["sk"]).decrypt(ct)}


def test_decrypt_matches_jax(pair, request):
    ANSWERS.check(request.node.name, *_decrypt_case(pair))


# -- (e) encoder --------------------------------------------------------------

_VALUES = {
    "complex vector": (ENCODED, 2.0 ** 40),
    "short real vector": (np.array([0.5, -1.25, 3.0, 1e-3]), 2.0 ** 30),
    "real scalar": (-2.75, 2.0 ** 40),
    "complex scalar": (1.5 - 0.25j, 2.0 ** 40),
    "wide tier": (np.linspace(-100.0, 100.0, N // 2), 2.0 ** 55),
}


def _encode_case(c, case):
    values, scale = _VALUES[case]
    with _host_paths():
        pt = c["k"].Encoder(c["ctx"]).encode(values, scale)
    return {"values": np.asarray(values), "scale": scale}, {"plain": pt}


@pytest.mark.parametrize("case", list(_VALUES))
def test_encode_matches_jax_host_ladder(pair, case, request):
    ANSWERS.check(request.node.name, *_encode_case(pair, case))


def _decode_case(c, case):
    """Decode a fresh encryption at the first level and a product at the
    next level (fewer limbs); float64 equality, bit for bit."""
    values, scale = _VALUES[case]
    k, ctx = c["k"], c["ctx"]
    with _host_paths():
        enc, dec = k.Encoder(ctx), k.Decryptor(ctx, c["sk"])
        ct = k.Encryptor(ctx, secret_key=c["sk"]).encrypt_symmetric(enc.encode(values, scale))
        plain = dec.decrypt(ct)
        outs = {"decoded": enc.decode(plain)}
        # a plaintext one level down, same residues in both packages
        plain.parms_id = ctx.first_context_data().next_context_data.parms_id
        plain.rns_data = (plain.rns_data[:-1] if c["side"] == "port"
                          else (plain.rns_data[0][:-1], plain.rns_data[1][:-1]))
        outs["decoded one level down"] = enc.decode(plain)
    return {"ciphertext": ct}, outs


@pytest.mark.parametrize("case", ["complex vector", "wide tier"])
def test_decode_matches_jax_host_ladder(pair, case, request):
    ANSWERS.check(request.node.name, *_decode_case(pair, case))


# -- (f) convert and refusals -----------------------------------------------

def test_convert_round_trips(pair):
    p = pair
    sk, pid = C.secret_key_to_numpy(p["sk"])
    back = C.secret_key_from_numpy(sk, pid, "cpu")
    assert torch.equal(back.data, p["sk"].data) and back.parms_id == pid
    pk, pid = C.public_key_to_numpy(p["pk"])
    assert torch.equal(C.public_key_from_numpy(pk, pid, "cpu").data.data, p["pk"].data.data)
    pt = P.CKKSEncoder(p["ctx"]).encode([1.0, 2.0], 2.0 ** 30)
    data, pid, scale = C.plaintext_to_numpy(pt)
    again = C.plaintext_from_numpy(data, pid, scale, "cpu")
    assert torch.equal(again.rns_data, pt.rns_data) and (again.parms_id, again.scale) == (pid, scale)
    factory = C.factory_from_settings(2, SEED)
    assert C.factory_to_settings(factory) == (2, SEED) and factory.prng_type == P.PRNGType.SHAKE256


def test_unported_client_parts_raise(pair):
    """BGV's client, the last scheme's to be ported, runs now
    (tests/test_torch_bgv.py holds it to the JAX package): a BGV encryption
    is in NTT form and decrypts, and what raises is a BGV ciphertext in
    coefficient form, as in the JAX package."""
    parms = P.EncryptionParameters(P.SchemeType.BGV)
    parms.set_poly_modulus_degree(1024)
    parms.set_coeff_modulus(P.CoeffModulus.create(1024, [40, 40, 40]))
    parms.set_plain_modulus(P.Modulus(65537))
    ctx = P.SealContext(parms, True, P.SecurityLevel.NONE, device="cpu")
    sk = P.KeyGenerator(ctx).secret_key
    ct = P.Encryptor(ctx, secret_key=sk).encrypt_symmetric(P.Plaintext.from_coeffs([1, 2, 3]))
    assert ct.is_ntt_form and ct.correction_factor == 1
    assert list(P.Decryptor(ctx, sk).decrypt(ct).coeff_data) == [1, 2, 3]
    with pytest.raises(ValueError, match="BGV encrypted must be in NTT form"):
        P.Decryptor(ctx, sk).invariant_noise_budget(P.Ciphertext(torch.zeros((2, 2, 1024), dtype=torch.int64),
                                                                 ctx.first_parms_id, False, 1.0))


# -- (g) the round trip --------------------------------------------------------

def _round_trip_case(c):
    k, ctx = c["k"], c["ctx"]
    scale = 2.0 ** 40
    a = np.linspace(-1.0, 1.0, N // 2)
    b = np.linspace(0.5, -0.5, N // 2) + 0.25j
    with _host_paths():
        ev, enc = k.Evaluator(ctx), k.Encoder(ctx)
        ct1 = k.Encryptor(ctx, secret_key=c["sk"]).encrypt_symmetric(enc.encode(a, scale))
        ct2 = k.Encryptor(ctx, public_key=c["pk"]).encrypt(enc.encode(b, scale))
        out = ev.rescale_to_next(ev.relinearize(ev.multiply(ct1, ct2), c["rk"]))
        plain = k.Decryptor(ctx, c["sk"]).decrypt(out)
        values = enc.decode(plain)
    assert np.max(np.abs(values - a * b)) < 1e-6
    return {"a": a, "b": b}, {"ciphertext": out, "plain": plain, "decoded": values}


def test_round_trip_equals_jax(pair, request):
    ANSWERS.check(request.node.name, *_round_trip_case(pair))


def answers(side):
    """(case id, inputs, outputs) of every case that reads frozen answers."""
    c = _client(side)
    yield "test_secret_key_matches_jax", SEEDS, {"secret_key": c["sk"]}
    yield "test_public_key_matches_jax", SEEDS, {"public_key": c["pk"]}
    yield "test_relin_keys_match_jax", SEEDS, {"relin_keys": c["rk"]}
    yield ("test_relin_key_for_a_cube_matches_jax", *_cube_case(c))
    for save_seed in (False, True):
        yield (f"test_encrypt_symmetric_matches_jax[{save_seed}]", *_symmetric_case(c, save_seed))
    yield ("test_encrypt_with_public_key_matches_jax", *_public_case(c))
    yield ("test_decrypt_matches_jax", *_decrypt_case(c))
    for case in _VALUES:
        yield (f"test_encode_matches_jax_host_ladder[{case}]", *_encode_case(c, case))
    for case in ("complex vector", "wide tier"):
        yield (f"test_decode_matches_jax_host_ladder[{case}]", *_decode_case(c, case))
    yield ("test_round_trip_equals_jax", *_round_trip_case(c))


@pytest.mark.slow
def test_frozen_answers_equal_the_jax_package():
    JA.check_twin(__file__, answers("jax"), answers("port"))
