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
to the same bytes.  Every comparison is exact: integers are equal, and the
decoded float64 values are equal bit for bit, no tolerance.
"""

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
from seal_tpu.ops import u64 as JU
from seal_tpu.params import EncryptionParameters as JaxParameters, SchemeType as JaxScheme
from seal_tpu.random import PRNGType as JaxPRNGType, UniformRandomGeneratorFactory as JaxFactory
from seal_tpu.random import sampler as JS

import seal_tpu_torch as P
from seal_tpu_torch import convert as C
from seal_tpu_torch.random import prng as PP
from seal_tpu_torch.random import sampler as PS

N = 1024
BITS = [60, 40, 40, 40, 60]
SEED = (1, 2, 3, 4, 5, 6, 7, 8)      # __graft_entry__._build's factory seed


def _eq(jax_value, port_tensor):
    np.testing.assert_array_equal(JU.to_np_u64(jax_value), C.u64_to_numpy(port_tensor))


@pytest.fixture(scope="module")
def pair():
    """Both packages' contexts, keys and PRNG factories, built once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAL_TPU_DEVICE_SAMPLING", "0")
        jp = JaxParameters(JaxScheme.CKKS)
        jp.set_poly_modulus_degree(N)
        jp.set_coeff_modulus(JaxCoeffModulus.create(N, BITS))
        jp.set_random_generator(JaxFactory(JaxPRNGType.BLAKE2XB, SEED))
        jctx = JaxContext(jp, True, JaxSecurityLevel.NONE)
        jkg = JaxKeyGenerator(jctx)
        j = {"ctx": jctx, "kg": jkg, "sk": jkg.secret_key, "pk": jkg.create_public_key(),
             "rk": jkg.create_relin_keys()}

    pp = P.EncryptionParameters(P.SchemeType.CKKS)
    pp.set_poly_modulus_degree(N)
    pp.set_coeff_modulus(P.CoeffModulus.create(N, BITS))
    pp.set_random_generator(C.factory_from_settings(*C.factory_to_settings(jp.random_generator)))
    pctx = P.SealContext(pp, True, P.SecurityLevel.NONE, device="cpu")
    assert pctx.key_parms_id == jctx.key_parms_id
    pkg = P.KeyGenerator(pctx)
    p = {"ctx": pctx, "kg": pkg, "sk": pkg.secret_key, "pk": pkg.create_public_key(),
         "rk": pkg.create_relin_keys()}
    return j, p


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

def test_secret_key_matches_jax(pair):
    j, p = pair
    _eq(j["sk"].data, p["sk"].data)
    assert p["sk"].parms_id == j["sk"].parms_id


def test_public_key_matches_jax(pair):
    j, p = pair
    _eq(j["pk"].data.data, p["pk"].data.data)
    assert p["pk"].parms_id == j["pk"].parms_id


def test_relin_keys_match_jax(pair):
    j, p = pair
    for part in ("c0", "c1"):
        _eq(j["rk"].key(2)[part], p["rk"].key(2)[part])
    assert p["rk"].parms_id == j["rk"].parms_id


def test_relin_key_for_a_cube_matches_jax(pair):
    """count=2 adds the key for s^3 (the secret-key power cache)."""
    j, p = pair
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAL_TPU_DEVICE_SAMPLING", "0")
        jrk = j["kg"].create_relin_keys(count=2)
    prk = p["kg"].create_relin_keys(count=2)
    _eq(jrk.key(3)["c0"], prk.key(3)["c0"])


# -- (c, d) encryption and decryption ---------------------------------------

@pytest.fixture(scope="module")
def encoded(pair):
    j, p = pair
    vals = np.linspace(-1.0, 1.0, N // 2) + 0.5j * np.linspace(0.3, -0.7, N // 2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAL_TPU_DEVICE_FFT", "0")
        mp.setenv("SEAL_TPU_DEVICE_COMPOSE", "0")
        jpt = JaxEncoder(j["ctx"]).encode(vals, 2.0 ** 40)
    ppt = P.CKKSEncoder(p["ctx"]).encode(vals, 2.0 ** 40)
    return vals, jpt, ppt


@pytest.mark.parametrize("save_seed", [False, True])
def test_encrypt_symmetric_matches_jax(pair, encoded, save_seed):
    j, p = pair
    _, jpt, ppt = encoded
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAL_TPU_DEVICE_SAMPLING", "0")
        jct = JaxEncryptor(j["ctx"], secret_key=j["sk"]).encrypt_symmetric(jpt, save_seed=save_seed)
    pct = P.Encryptor(p["ctx"], secret_key=p["sk"]).encrypt_symmetric(ppt, save_seed=save_seed)
    _eq(jct.data, pct.data)
    assert (pct.parms_id, pct.scale, pct.is_ntt_form) == (jct.parms_id, jct.scale, jct.is_ntt_form)
    if save_seed:
        assert pct.seed_info.seed == jct.seed_info.seed
        assert int(pct.seed_info.prng_type) == int(jct.seed_info.prng_type)


def test_encrypt_with_public_key_matches_jax(pair, encoded):
    j, p = pair
    _, jpt, ppt = encoded
    jct = JaxEncryptor(j["ctx"], public_key=j["pk"]).encrypt(jpt)
    pct = P.Encryptor(p["ctx"], public_key=p["pk"]).encrypt(ppt)
    _eq(jct.data, pct.data)
    assert (pct.parms_id, pct.scale) == (jct.parms_id, jct.scale)


def test_decrypt_matches_jax(pair, encoded):
    j, p = pair
    _, jpt, ppt = encoded
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAL_TPU_DEVICE_SAMPLING", "0")
        jct = JaxEncryptor(j["ctx"], secret_key=j["sk"]).encrypt_symmetric(jpt)
    pct = P.Encryptor(p["ctx"], secret_key=p["sk"]).encrypt_symmetric(ppt)
    jdp = JaxDecryptor(j["ctx"], j["sk"]).decrypt(jct)
    pdp = P.Decryptor(p["ctx"], p["sk"]).decrypt(pct)
    _eq(jdp.rns_data, pdp.rns_data)
    assert (pdp.parms_id, pdp.scale) == (jdp.parms_id, jdp.scale)


# -- (e) encoder --------------------------------------------------------------

def _host_ladder(monkeypatch):
    monkeypatch.setenv("SEAL_TPU_DEVICE_FFT", "0")
    monkeypatch.setenv("SEAL_TPU_DEVICE_COMPOSE", "0")


_VALUES = {
    "complex vector": (np.linspace(-1.0, 1.0, N // 2) + 0.5j * np.linspace(0.3, -0.7, N // 2), 2.0 ** 40),
    "short real vector": (np.array([0.5, -1.25, 3.0, 1e-3]), 2.0 ** 30),
    "real scalar": (-2.75, 2.0 ** 40),
    "complex scalar": (1.5 - 0.25j, 2.0 ** 40),
    "wide tier": (np.linspace(-100.0, 100.0, N // 2), 2.0 ** 55),
}


@pytest.mark.parametrize("case", list(_VALUES))
def test_encode_matches_jax_host_ladder(pair, monkeypatch, case):
    j, p = pair
    _host_ladder(monkeypatch)
    values, scale = _VALUES[case]
    jpt = JaxEncoder(j["ctx"]).encode(values, scale)
    ppt = P.CKKSEncoder(p["ctx"]).encode(values, scale)
    _eq(jpt.rns_data, ppt.rns_data)
    assert (ppt.parms_id, ppt.scale) == (jpt.parms_id, jpt.scale)


@pytest.mark.parametrize("case", ["complex vector", "wide tier"])
def test_decode_matches_jax_host_ladder(pair, monkeypatch, case):
    """Decode a fresh encryption at the first level and a product at the
    next level (fewer limbs); float64 equality, bit for bit."""
    j, p = pair
    _host_ladder(monkeypatch)
    monkeypatch.setenv("SEAL_TPU_DEVICE_SAMPLING", "0")
    values, scale = _VALUES[case]
    je, pe = JaxEncoder(j["ctx"]), P.CKKSEncoder(p["ctx"])
    jct = JaxEncryptor(j["ctx"], secret_key=j["sk"]).encrypt_symmetric(je.encode(values, scale))
    pct = P.Encryptor(p["ctx"], secret_key=p["sk"]).encrypt_symmetric(pe.encode(values, scale))
    jdec, pdec = JaxDecryptor(j["ctx"], j["sk"]), P.Decryptor(p["ctx"], p["sk"])
    got, want = pe.decode(pdec.decrypt(pct)), je.decode(jdec.decrypt(jct))
    np.testing.assert_array_equal(got, want)
    pdp = pdec.decrypt(pct)
    jdp = jdec.decrypt(jct)
    # a plaintext one level down, same residues in both packages
    nxt = p["ctx"].first_context_data().next_context_data.parms_id
    pdp.rns_data, pdp.parms_id = pdp.rns_data[:-1], nxt
    jdp.rns_data, jdp.parms_id = (jdp.rns_data[0][:-1], jdp.rns_data[1][:-1]), nxt
    np.testing.assert_array_equal(pe.decode(pdp), je.decode(jdp))


# -- (f) convert and refusals -----------------------------------------------

def test_convert_round_trips(pair):
    _, p = pair
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

def test_round_trip_equals_jax(pair, monkeypatch):
    j, p = pair
    _host_ladder(monkeypatch)
    monkeypatch.setenv("SEAL_TPU_DEVICE_SAMPLING", "0")
    scale = 2.0 ** 40
    a = np.linspace(-1.0, 1.0, N // 2)
    b = np.linspace(0.5, -0.5, N // 2) + 0.25j

    def run(ctx, keys, encoder, encryptor, decryptor, evaluator):
        ev, enc = evaluator(ctx), encoder(ctx)
        ct1 = encryptor(ctx, secret_key=keys["sk"]).encrypt_symmetric(enc.encode(a, scale))
        ct2 = encryptor(ctx, public_key=keys["pk"]).encrypt(enc.encode(b, scale))
        out = ev.rescale_to_next(ev.relinearize(ev.multiply(ct1, ct2), keys["rk"]))
        plain = decryptor(ctx, keys["sk"]).decrypt(out)
        return out, plain, enc.decode(plain)

    jout, jplain, jvals = run(j["ctx"], j, JaxEncoder, JaxEncryptor, JaxDecryptor, JaxEvaluator)
    pout, pplain, pvals = run(p["ctx"], p, P.CKKSEncoder, P.Encryptor, P.Decryptor, P.Evaluator)
    _eq(jout.data, pout.data)
    assert (pout.parms_id, pout.scale) == (jout.parms_id, jout.scale)
    _eq(jplain.rns_data, pplain.rns_data)
    np.testing.assert_array_equal(pvals, jvals)
    assert np.max(np.abs(pvals - a * b)) < 1e-6
