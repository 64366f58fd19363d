"""The port's wire format and the modules around it, against the JAX package.

Objects are made by the port on the CPU from a seeded BLAKE2XB factory at
N=64 (BFV, BGV and CKKS on coefficient moduli [40, 40, 40],
``SecurityLevel.NONE``) and carried into the JAX package's objects as numpy
uint64 arrays (``seal_tpu.ops.u64.from_np_u64``), seeds included; the JAX
package's serialization runs on the host, so no JAX op is compiled for it.

(a) per module: ``UniformRandomGeneratorInfo``, the legacy SEAL 3.4 / 3.5
    uniform samplers (against Microsoft SEAL's vectors and the JAX
    functions, the rejection path included), ``sample_poly_noise``, the new
    methods of ``data.py``, the ``modulus.py`` names, ``encode_int``,
    ``parameter_error_message`` and ``print_parameters``;
(b) every object kind, scheme and compression mode: the port's save equals
    the JAX package's byte for byte, the port loads the JAX bytes to the
    object that was saved, the JAX package loads the port's bytes to it;
    the SEAL 3.4 header upgrade;
(c) hostile input: every case of ``tests/test_serialization_adversarial.py``
    with the same verdict in both packages, a coefficient of 2^64 - 1, and
    a hypothesis differential test over truncations and byte flips;
(d) ``valcheck`` and the evaluator's rejections over the cases of
    ``tests/test_valcheck.py``.
"""

import functools
import io
import struct
import zlib
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from seal_tpu import serialization as JS
from seal_tpu import valcheck as JV
from seal_tpu.ckks_encoder import CKKSEncoder as JaxCKKSEncoder
from seal_tpu.context import SealContext as JaxContext
from seal_tpu.data import (Ciphertext as JaxCiphertext, GaloisKeys as JaxGaloisKeys, KSwitchKeys as JaxKSwitchKeys,
                           Plaintext as JaxPlaintext, PublicKey as JaxPublicKey, RelinKeys as JaxRelinKeys,
                           SecretKey as JaxSecretKey)
from seal_tpu.evaluator import Evaluator as JaxEvaluator
from seal_tpu import modulus as JM
from seal_tpu.ops import u64 as JU
from seal_tpu.params import EncryptionParameters as JaxParameters, SchemeType as JaxScheme
from seal_tpu.random import prng as JP
from seal_tpu.random import sampler as JSam
from seal_tpu.utils import print_parameters as jax_print_parameters

import seal_tpu_torch as P
from seal_tpu_torch import convert as C
from seal_tpu_torch import golden
from seal_tpu_torch import modulus as PM
from seal_tpu_torch import serialization as S
from seal_tpu_torch import valcheck as V
from seal_tpu_torch.random import prng as PP
from seal_tpu_torch.random import sampler as PSam

N = 64
BITS = [40, 40, 40]
SEED = (21, 22, 23, 24, 25, 26, 27, 28)
SCHEMES = ["bfv", "bgv", "ckks"]
MODES = {"none": S.COMPR_NONE, "zlib": S.COMPR_ZLIB, "zstd": S.COMPR_ZSTD}
WIRE = "tests/data/wire"


def _parms(pkg, scheme):
    """The same parameters in either package (``pkg`` is the port or the
    JAX package's module set)."""
    Params, Scheme, Coeff, Plain = pkg
    p = Params(getattr(Scheme, scheme.upper()))
    p.set_poly_modulus_degree(N)
    p.set_coeff_modulus(Coeff.create(N, BITS))
    if scheme != "ckks":
        p.set_plain_modulus(Plain.batching(N, 20))
    return p


PORT = (P.EncryptionParameters, P.SchemeType, P.CoeffModulus, P.PlainModulus)
JAX = (JaxParameters, JaxScheme, JM.CoeffModulus, JM.PlainModulus)


def _client(scheme):
    """The port's objects of every kind, and the two contexts."""
    parms = _parms(PORT, scheme)
    parms.set_random_generator(P.UniformRandomGeneratorFactory(P.PRNGType.BLAKE2XB, SEED))
    ctx = P.SealContext(parms, True, P.SecurityLevel.NONE, device="cpu")
    jctx = JaxContext(_parms(JAX, scheme), True, JM.SecurityLevel.NONE)
    kg = P.KeyGenerator(ctx)
    sk = kg.secret_key
    pk = kg.create_public_key()
    enc = P.Encryptor(ctx, pk, sk)
    cd = ctx.first_context_data()
    if scheme == "ckks":
        plain = P.CKKSEncoder(ctx).encode(np.linspace(-1, 1, N // 2), 2.0 ** 20)
    else:
        plain = P.BatchEncoder(ctx).encode(np.arange(N, dtype=np.uint64) % 11)
    ct = enc.encrypt_symmetric(plain)
    ev = P.Evaluator(ctx)
    objs = {
        "params": ctx.key_context_data().parms,
        "plain_coeff": P.Plaintext.from_hex("3x^5 + 2x^3 + 1x^1 + 5"),
        "plain_ntt": C.plaintext_from_numpy(golden.plain_inputs(ctx, 5), ctx.first_parms_id, 2.0 ** 20, "cpu"),
        "ct": ct,
        "ct_seeded": enc.encrypt_symmetric(plain, save_seed=True),
        "ct_public": enc.encrypt(plain),
        "ct_size3": ev.multiply(ct, enc.encrypt(plain)),
        "ct_switched": ev.mod_switch_to_next(ct),
        "sk": sk,
        "pk": pk,
        "rk": kg.create_relin_keys(),
        "rk_seeded": kg.create_relin_keys(save_seed=True),
        "gk": kg.create_galois_keys_from_steps([1]),
        "gk_seeded": kg.create_galois_keys_from_steps([1], save_seed=True),
    }
    assert cd.parms_id == jctx.first_parms_id
    return ctx, jctx, objs


@pytest.fixture(scope="module")
def clients():
    return {s: _client(s) for s in SCHEMES}


# -- carrying the port's objects into the JAX package -----------------------------------

def _jax_info(info):
    return None if info is None else JP.UniformRandomGeneratorInfo(JP.PRNGType(int(info.prng_type)), info.seed)


def _jax_ct(ct):
    out = JaxCiphertext(JU.from_np_u64(ct.to_np()), ct.parms_id, ct.is_ntt_form, ct.scale, ct.correction_factor)
    out.seed_info = _jax_info(ct.seed_info)
    return out


def _jax_pt(p):
    if not p.is_ntt_form:
        return JaxPlaintext.from_coeffs(p.coeff_data)
    out = JaxPlaintext()
    out.parms_id, out.scale, out.rns_data = p.parms_id, p.scale, JU.from_np_u64(C.u64_to_numpy(p.rns_data))
    return out


def _jax_keys(keys, cls):
    out = cls()
    out.parms_id = keys.parms_id
    out.keys = [None if e is None else {
        "c0": JU.from_np_u64(C.u64_to_numpy(e["c0"])), "c1": JU.from_np_u64(C.u64_to_numpy(e["c1"])),
        "seeds": None if e.get("seeds") is None else [_jax_info(x) for x in e["seeds"]]} for e in keys.keys]
    return out


# (port save, JAX save, port load, JAX load, carry into JAX, host arrays of an object)
def _kinds():
    def keys(cls, jcls):
        return (lambda o, ctx, m: S.kswitch_keys_save(o, ctx, m), lambda o, ctx, m: JS.kswitch_keys_save(o, ctx, m),
                lambda b, ctx: S.kswitch_keys_load(b, ctx, cls), lambda b, ctx: JS.kswitch_keys_load(b, ctx, jcls),
                lambda o: _jax_keys(o, jcls))

    def no_ctx(save):
        return lambda o, ctx, m: save(o, m)

    ct = (no_ctx(S.ciphertext_save), no_ctx(JS.ciphertext_save), S.ciphertext_load, JS.ciphertext_load, _jax_ct)
    return {
        "params": (no_ctx(S.params_save), no_ctx(JS.params_save), lambda b, ctx: S.params_load(b),
                   lambda b, ctx: JS.params_load(b), lambda o: _parms(JAX, o.scheme.name.lower())),
        "plain": (no_ctx(S.plaintext_save), no_ctx(JS.plaintext_save), S.plaintext_load, JS.plaintext_load, _jax_pt),
        "ct": ct,
        "sk": (no_ctx(S.secret_key_save), no_ctx(JS.secret_key_save), S.secret_key_load, JS.secret_key_load,
               lambda o: JaxSecretKey(JU.from_np_u64(C.u64_to_numpy(o.data)), o.parms_id)),
        "pk": (no_ctx(S.public_key_save), no_ctx(JS.public_key_save), S.public_key_load, JS.public_key_load,
               lambda o: JaxPublicKey(_jax_ct(o.data))),
        "rk": keys(P.RelinKeys, JaxRelinKeys),
        "gk": keys(P.GaloisKeys, JaxGaloisKeys),
    }


KINDS = _kinds()
OBJECTS = ["params", "plain_coeff", "plain_ntt", "ct", "ct_seeded", "ct_public", "ct_size3", "ct_switched", "sk",
           "pk", "rk", "rk_seeded", "gk", "gk_seeded"]


def _kind(name):
    return name.split("_")[0] if not name.startswith("plain") else "plain"


def _arrays(obj):
    """An object of either package as comparable host values."""
    if isinstance(obj, (P.Ciphertext, JaxCiphertext)):
        return ("ct", obj.to_np(), tuple(obj.parms_id), obj.is_ntt_form, obj.scale, obj.correction_factor)
    if isinstance(obj, (P.Plaintext, JaxPlaintext)):
        if obj.is_ntt_form:
            data = C.u64_to_numpy(obj.rns_data) if isinstance(obj, P.Plaintext) else JU.to_np_u64(obj.rns_data)
            return ("pt", data, tuple(obj.parms_id), obj.scale)
        return ("pt", np.asarray(obj.coeff_data, np.uint64), obj.scale)
    if isinstance(obj, (P.SecretKey, JaxSecretKey)):
        data = C.u64_to_numpy(obj.data) if isinstance(obj, P.SecretKey) else JU.to_np_u64(obj.data)
        return ("sk", data, tuple(obj.parms_id))
    if isinstance(obj, (P.PublicKey, JaxPublicKey)):
        return ("pk",) + _arrays(obj.data)
    if isinstance(obj, (P.KSwitchKeys, JaxKSwitchKeys)):
        host = C.u64_to_numpy if isinstance(obj, P.KSwitchKeys) else JU.to_np_u64
        return ("keys", tuple(obj.parms_id), [None if e is None else (host(e["c0"]), host(e["c1"])) for e in obj.keys])
    return ("params", tuple(obj.parms_id))


def _same(a, b):
    assert len(a) == len(b) and type(a) is type(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        elif isinstance(x, (list, tuple)):
            _same(x, y)
        else:
            assert x == y


# -- (a) per module -----------------------------------------------------------------------

@pytest.mark.parametrize("prng_type", [1, 2])
@pytest.mark.parametrize("seed", [SEED, (0,) * 8, tuple((1 << 64) - 1 - i for i in range(8))])
def test_generator_info(prng_type, seed):
    port = PP.UniformRandomGeneratorInfo(PP.PRNGType(prng_type), seed)
    jax = JP.UniformRandomGeneratorInfo(JP.PRNGType(prng_type), seed)
    raw = port.save_members()
    assert raw == jax.save_members() and len(raw) == PP.UniformRandomGeneratorInfo.SAVE_SIZE_RAW == 65
    assert PP.UniformRandomGeneratorInfo.load_members(raw) == port
    assert port.make_prng().generate(5000) == jax.make_prng().generate(5000)
    assert PP.UniformRandomGeneratorInfo(PP.PRNGType.UNKNOWN, seed).make_prng() is None
    assert P.UniformRandomGeneratorFactory(P.PRNGType.BLAKE2XB, seed).use_random_seed is False
    assert P.UniformRandomGeneratorFactory().use_random_seed is True


def _legacy_moduli():
    with open(f"{WIRE}/legacy_uniform_moduli.txt") as f:
        return [int(line) for line in f if line.strip()]


LEGACY_SEED = (0x5EA1, 1, 2, 3, 4, 5, 6, 7)


@pytest.mark.parametrize("version", ["3_4", "3_5"])
def test_legacy_uniform_matches_reference(version):
    moduli = _legacy_moduli()
    with open(f"{WIRE}/legacy_uniform_{version}.bin", "rb") as f:
        want = np.frombuffer(f.read(), dtype="<u8").reshape(len(moduli), 64)
    fn = getattr(PSam, f"sample_poly_uniform_seal_{version}")
    np.testing.assert_array_equal(fn(PP.Blake2xbPRNG(LEGACY_SEED), 64, moduli), want)


@pytest.mark.parametrize("version", ["3_4", "3_5"])
@pytest.mark.parametrize("n,moduli", [(64, None), (256, [(1 << 60) - 257]), (1024, [(1 << 62) + 135, 97]),
                                      (128, [(1 << 61) - 1, 3])])
def test_legacy_uniform_matches_jax(version, n, moduli):
    """Moduli near 2^62 reject about a quarter of the 3.4 sampler's attempts
    and a fifth of the 3.5 one's: the redraw order and the bytes it
    consumes must match, so a second draw from the same stream agrees too."""
    moduli = moduli or _legacy_moduli()
    port_prng, jax_prng = PP.Blake2xbPRNG(LEGACY_SEED), JP.Blake2xbPRNG(LEGACY_SEED)
    for _ in range(2):
        got = getattr(PSam, f"sample_poly_uniform_seal_{version}")(port_prng, n, moduli)
        want = getattr(JSam, f"sample_poly_uniform_seal_{version}")(jax_prng, n, moduli)
        np.testing.assert_array_equal(got, want)
        assert all(int(got[i].max()) < q for i, q in enumerate(moduli))
    assert port_prng.generate(8) == jax_prng.generate(8)


def test_noise_sampler_matches_jax():
    moduli = [(1 << 40) - 87, 97]
    np.testing.assert_array_equal(PSam.sample_poly_noise(PP.Blake2xbPRNG(SEED), 1024, moduli),
                                  JSam.sample_poly_noise(JP.Blake2xbPRNG(SEED), 1024, moduli))
    assert PSam.sample_poly_noise is PSam.sample_poly_cbd


HEX = ["0", "1", "5", "1x^1", "x", "x^3", "3x^5 + 2x^3 + 1x^1 + 5", "FFx^2 + ABx^1 + 1", "1x^10 + 0",
       "9x^10 + Cx^8 + Ax^6 + 21x^5 + 4x^4 + 16x^3 + 1x^2 + Bx^1 + 1E", "2x^1 + 3x^1", "", "7x^63"]


@pytest.mark.parametrize("text", HEX)
def test_plaintext_hex(text):
    port, jax = P.Plaintext.from_hex(text), JaxPlaintext.from_hex(text)
    np.testing.assert_array_equal(port.coeff_data, jax.coeff_data)
    assert port.to_string() == jax.to_string()
    assert port.coeff_count == jax.coeff_count
    assert P.Plaintext.from_hex(port.to_string()) == port


@pytest.mark.parametrize("a,b", [([1, 2, 0], [1, 2]), ([1, 2], [1, 3]), ([], [0, 0]), ([0, 5], [0, 5, 0, 0]),
                                 ([7], [])])
def test_plaintext_equality(a, b):
    pa, pb = P.Plaintext.from_coeffs(a), P.Plaintext.from_coeffs(b)
    assert (pa == pb) == (JaxPlaintext.from_coeffs(a) == JaxPlaintext.from_coeffs(b))


def test_data_methods(clients):
    ctx, jctx, objs = clients["ckks"]
    ct, jct = objs["ct_size3"], _jax_ct(objs["ct_size3"])
    assert ct.poly_modulus_degree == jct.poly_modulus_degree == N
    assert ct.to_np().dtype == np.uint64 and ct.to_np().shape == (3, len(BITS) - 1, N)
    np.testing.assert_array_equal(ct.to_np(), jct.to_np())
    ntt, jntt = objs["plain_ntt"], _jax_pt(objs["plain_ntt"])
    assert ntt.coeff_count == jntt.coeff_count == (len(BITS) - 1) * N
    assert ntt == C.plaintext_from_numpy(C.u64_to_numpy(ntt.rns_data), ntt.parms_id, 1.0, "cpu")
    assert ntt != objs["plain_coeff"] and (jntt == _jax_pt(objs["plain_coeff"])) is False
    for keys in ("rk", "gk", "gk_seeded"):
        assert objs[keys].size() == _jax_keys(objs[keys], JaxKSwitchKeys).size() == 1
    sk = P.SecretKey(objs["sk"].data.clone(), objs["sk"].parms_id)
    sk.zeroize()
    assert sk.parms_id == P.PARMS_ID_ZERO and not sk.data.any() and sk.data.shape == objs["sk"].data.shape
    assert objs["sk"].data.any()


def test_modulus_names():
    for name in ("CIPHERTEXT_SIZE_MIN", "CIPHERTEXT_SIZE_MAX", "HE_STD_ERROR_STD_DEV", "NOISE_MAX_DEVIATION"):
        assert getattr(PM, name) == getattr(JM, name)
    assert PSam.NOISE_MAX_DEVIATION == PM.NOISE_MAX_DEVIATION
    moduli = PM.CoeffModulus.create(1024, [30, 40, 50])
    assert PM.product(moduli) == JM.product(JM.CoeffModulus.create(1024, [30, 40, 50])) == \
        moduli[0].value * moduli[1].value * moduli[2].value
    assert PM.product([]) == 1
    for v in (0, 5, -5, (1 << 200) + 3):
        assert PM.Modulus(97).reduce(v) == JM.Modulus(97).reduce(v)
    with pytest.raises(ValueError):
        PM.Modulus(0).reduce(3)


@pytest.mark.parametrize("value", [0, 1, -1, 123456789, -(1 << 62), (1 << 63) - 1])
def test_encode_int(clients, value):
    ctx, jctx, objs = clients["ckks"]
    for level in (ctx.first_parms_id, ctx.last_parms_id):
        got = P.CKKSEncoder(ctx).encode_int(value, level)
        want = JaxCKKSEncoder(jctx).encode_int(value, level)
        assert got.parms_id == tuple(want.parms_id) and got.scale == want.scale == 1.0
        np.testing.assert_array_equal(C.u64_to_numpy(got.rns_data), JU.to_np_u64(want.rns_data))
    assert P.CKKSEncoder(ctx).encode_int(value).parms_id == ctx.first_parms_id


@pytest.mark.parametrize("case", ["valid", "no_modulus", "big_plain", "odd_degree", "plain_equals_q", "ckks_plain"])
def test_parameter_error_message(case):
    def build(pkg, sec):
        Params, Scheme, Coeff, Plain = pkg
        p = Params(Scheme.CKKS if case == "ckks_plain" else Scheme.BFV)
        p.set_poly_modulus_degree(48 if case == "odd_degree" else 64)
        if case != "no_modulus":
            p.set_coeff_modulus(Coeff.create(64, BITS))
        if case == "big_plain":
            p.set_plain_modulus(Coeff.create(64, [50])[0].value)
        elif case == "plain_equals_q":
            p.set_plain_modulus(p.coeff_modulus[0].value)
        elif case != "ckks_plain":
            p.set_plain_modulus(Plain.batching(64, 20))
        return p

    port = P.SealContext(build(PORT, None), True, P.SecurityLevel.NONE, device="cpu")
    jax = JaxContext(build(JAX, None), True, JM.SecurityLevel.NONE)
    assert port.parameter_error_message() == jax.parameter_error_message()
    assert port.parameter_error_name() == jax.parameter_error_name()
    assert (port.key_context_data().qualifiers.parameter_error_message
            == jax.key_context_data().qualifiers.parameter_error_message)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_print_parameters(clients, scheme):
    ctx, jctx, _ = clients[scheme]
    port_out, jax_out = io.StringIO(), io.StringIO()
    with redirect_stdout(port_out):
        got = P.print_parameters(ctx)
    with redirect_stdout(jax_out):
        want = jax_print_parameters(jctx)
    assert got == want and port_out.getvalue() == jax_out.getvalue() == want + "\n"


# -- (b) every object, byte for byte ------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", OBJECTS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_save_load_byte_identical(clients, scheme, name, mode):
    ctx, jctx, objs = clients[scheme]
    psave, jsave, pload, jload, carry = KINDS[_kind(name)]
    obj = objs[name]
    port_bytes = psave(obj, ctx, MODES[mode])
    jax_bytes = jsave(carry(obj), jctx, MODES[mode])
    assert port_bytes == jax_bytes
    back, used = pload(jax_bytes, ctx)
    assert used == len(jax_bytes)
    _same(_arrays(back), _arrays(obj))
    jback, _ = jload(port_bytes, jctx)
    _same(_arrays(jback), _arrays(obj))
    if name.startswith("ct"):
        assert back.seed_info is None and back.data.device == ctx.device
    if name in ("ct_seeded", "rk_seeded", "gk_seeded"):
        # about half the size of the full object
        assert len(port_bytes) < 0.7 * len(psave(objs[name.split("_")[0]], ctx, MODES[mode]))
    if name in ("rk_seeded", "gk_seeded"):
        assert all(e is None or e["seeds"] is None for e in back.keys)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_convert_carries_seeds(clients, scheme):
    """A seeded ciphertext and seeded keys of the JAX package, carried into
    the port by ``convert`` with their seeds, save to the JAX package's
    bytes (the seeds as the JAX package's UniformRandomGeneratorInfo and as
    (type, words) pairs)."""
    ctx, jctx, objs = clients[scheme]
    jct = _jax_ct(objs["ct_seeded"])
    for seed in (jct.seed_info, (int(jct.seed_info.prng_type), jct.seed_info.seed)):
        ct = C.ciphertext_from_numpy(jct.to_np(), jct.parms_id, jct.is_ntt_form, jct.scale, "cpu",
                                     jct.correction_factor, seed_info=seed)
        assert S.ciphertext_save(ct) == JS.ciphertext_save(jct)
    jrk = _jax_keys(objs["rk_seeded"], JaxRelinKeys)
    entries = [None if e is None else (JU.to_np_u64(e["c0"]), JU.to_np_u64(e["c1"]), e["seeds"]) for e in jrk.keys]
    rk = C.relin_keys_from_numpy(entries, jrk.parms_id, "cpu")
    assert S.kswitch_keys_save(rk, ctx) == JS.kswitch_keys_save(jrk, jctx)
    assert C.ciphertext_from_numpy(jct.to_np(), jct.parms_id, True, 1.0, "cpu").seed_info is None


def test_default_compression():
    assert S.COMPR_MODE_DEFAULT == JS.COMPR_MODE_DEFAULT
    assert S._HAS_ZSTD == JS._HAS_ZSTD
    data = b"seal tpu torch" * 40
    for mode in MODES.values():
        blob = S.save_header_wrapped(data, mode)
        assert blob == JS.save_header_wrapped(data, mode)
        assert S.load_header_wrapped(blob) == (data, len(blob))


@pytest.mark.parametrize("compr", [S.COMPR_NONE, S.COMPR_ZLIB])
def test_legacy_3_4_header_upgrade(compr):
    members = struct.pack("<Q", 0x1234567890ABCDEF)
    payload = S._compress(members, compr)
    legacy = struct.pack("<HBBIQ", S.SEAL_MAGIC, 0, compr, S.SEAL_HEADER_SIZE + len(payload), 0) + payload
    assert S.load_header_wrapped(legacy) == JS.load_header_wrapped(legacy) == (members, len(legacy))
    assert S.modulus_load(legacy) == JS.modulus_load(legacy) == (0x1234567890ABCDEF, len(legacy))
    assert S.peek_version(legacy) == JS.peek_version(legacy) == (3, 4)
    bad = struct.pack("<HBBIQ", S.SEAL_MAGIC, 7, S.COMPR_NONE, 24, 0) + b"x" * 8
    trunc = struct.pack("<HBBIQ", S.SEAL_MAGIC, 0, S.COMPR_NONE, 1 << 20, 0)
    for blob in (bad, trunc):
        with pytest.raises(ValueError):
            S.load_header_wrapped(blob)


@pytest.mark.parametrize("version", [(3, 4), (3, 5), (3, 6), (3, 3), (2, 0)])
def test_seeded_expansion_by_version(clients, version):
    """A seeded ciphertext whose header says SEAL 3.x: 3.6 expands with the
    modern sampler, 3.4 and 3.5 with theirs, older versions are refused;
    3.x blobs carry no correction factor."""
    ctx, jctx, objs = clients["bfv"]
    ct = objs["ct_seeded"]
    members = S._ciphertext_members(ct.parms_id, ct.is_ntt_form, 2, ct.coeff_modulus_size, N, ct.scale,
                                    ct.correction_factor, ct.to_np()[0], ct.seed_info)
    members = members[:65] + members[73:]                      # no correction factor before 4.x
    blob = bytearray(S.save_header_wrapped(members, S.COMPR_NONE))
    if version == (3, 4):
        blob[:16] = struct.pack("<HBBIQ", S.SEAL_MAGIC, 0, S.COMPR_NONE, len(blob), 0)
    else:
        blob[3:5] = bytes(version)
    verdicts = []
    for load, context in ((S.ciphertext_load, ctx), (JS.ciphertext_load, jctx)):
        try:
            verdicts.append(_arrays(load(bytes(blob), context)[0]))
        except ValueError as e:
            verdicts.append(str(e))
    if version == (3, 3):
        assert verdicts[0] == verdicts[1] == "incompatible version"
        return
    if version == (2, 0):
        assert verdicts[0] == verdicts[1] == "unsupported version"
        return
    _same(verdicts[0], verdicts[1])
    moduli = ctx.first_context_data().coeff_modulus_values
    sampler = {(3, 4): PSam.sample_poly_uniform_seal_3_4, (3, 5): PSam.sample_poly_uniform_seal_3_5,
               (3, 6): PSam.sample_poly_uniform}[version]
    np.testing.assert_array_equal(verdicts[0][1][1], sampler(ct.seed_info.make_prng(), N, moduli))


# -- (c) hostile input --------------------------------------------------------------------

def _verdict(load, blob, context):
    """'ValueError', or the loaded object as host values."""
    try:
        obj = load(blob, context)[0]
    except ValueError:
        return "ValueError"
    return _arrays(obj)


def _with_header(members, compr=S.COMPR_NONE):
    return S.save_header_wrapped(members, compr)


def _adversarial_cases(objs, ctx):
    """(name, blob, which loader) for every case of the JAX package's
    adversarial tests; blobs are the port's, byte-identical to the JAX
    package's (test_save_load_byte_identical)."""
    params = S.params_save(objs["params"])
    ct_blob = S.ciphertext_save(objs["ct"], S.COMPR_NONE)
    cases = []
    for name, pos, value in (("wrong magic", 0, params[0] ^ 0xFF), ("wrong header size", 2, 0x20),
                             ("unsupported version", 3, 99)):
        blob = bytearray(params)
        blob[pos] = value
        cases.append((name, bytes(blob), "params"))
    for name, cut in (("truncated at 8", 8), ("truncated at 15", 15), ("truncated at half", len(ct_blob) // 2),
                      ("truncated at the last byte", len(ct_blob) - 1)):
        cases.append((name, ct_blob[:cut], "ct"))
    cases.append(("short header", b"\xa1\x5e", "ct"))
    cases.append(("garbage payload", _with_header(b"\x00" * 64), "ct"))
    members, _ = S.load_header_wrapped(ct_blob)
    arr = np.zeros(2 * len(BITS[:-1]) * N + 64, dtype="<u8")
    cases.append(("oversized DynArray", _with_header(members[:73] + S.dynarray_save(arr)), "ct"))
    seeded, _ = S.load_header_wrapped(S.ciphertext_save(objs["ct_seeded"], S.COMPR_NONE))
    cases.append(("seeded with size 3", _with_header(seeded[:33] + struct.pack("<Q", 3) + seeded[41:]), "ct"))
    # the first coefficient: 65 bytes of metadata, the correction factor,
    # the DynArray's header and count
    evil = members[:97] + struct.pack("<Q", 0xFFFF_FFFF_FFFF_FFFF) + members[105:]
    cases.append(("coefficient 2^64 - 1", _with_header(evil), "ct_data"))
    sk_blob = bytearray(S.secret_key_save(objs["sk"]))
    sk_blob[17] ^= 0x01
    cases.append(("secret key at a wrong level", bytes(sk_blob), "sk"))
    cases.append(("ciphertext in a wrong context", S.ciphertext_save(objs["ct"]), "ct_wrong_context"))
    return cases


@pytest.fixture(scope="module")
def adversarial(clients):
    ctx, jctx, objs = clients["bfv"]
    return {name: (blob, kind) for name, blob, kind in _adversarial_cases(objs, ctx)}


ADVERSARIAL = ["wrong magic", "wrong header size", "unsupported version", "truncated at 8", "truncated at 15",
               "truncated at half", "truncated at the last byte", "short header", "garbage payload",
               "oversized DynArray", "seeded with size 3", "coefficient 2^64 - 1", "secret key at a wrong level",
               "ciphertext in a wrong context", "zlib bomb", "round trip across modes"]


def _other_contexts():
    port = _parms(PORT, "bfv")
    port.set_poly_modulus_degree(128)
    port.set_coeff_modulus(P.CoeffModulus.create(128, [40, 40]))
    port.set_plain_modulus(P.PlainModulus.batching(128, 20))
    jax = _parms(JAX, "bfv")
    jax.set_poly_modulus_degree(128)
    jax.set_coeff_modulus(JM.CoeffModulus.create(128, [40, 40]))
    jax.set_plain_modulus(JM.PlainModulus.batching(128, 20))
    return (P.SealContext(port, True, P.SecurityLevel.NONE, device="cpu"),
            JaxContext(jax, True, JM.SecurityLevel.NONE))


@pytest.mark.parametrize("case", ADVERSARIAL)
def test_adversarial_same_verdict(clients, adversarial, case):
    ctx, jctx, objs = clients["bfv"]
    if case == "zlib bomb":
        huge = zlib.compress(b"\x00" * (1 << 20), 9)
        blob = struct.pack("<HBBBBHQ", S.SEAL_MAGIC, 16, 4, 4, S.COMPR_ZLIB, 0, 16 + len(huge)) + huge
        assert len(S.load_header_wrapped(blob)[0]) == len(JS.load_header_wrapped(blob)[0]) == 1 << 20
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(S, "MAX_DECOMPRESSED_SIZE", 1 << 10)
            mp.setattr(JS, "MAX_DECOMPRESSED_SIZE", 1 << 10)
            for module in (S, JS):
                with pytest.raises(ValueError, match="safety bound"):
                    module.load_header_wrapped(blob)
        return
    if case == "round trip across modes":
        port, jax = objs["ct"], _jax_ct(objs["ct"])
        for mode in MODES.values():
            port, _ = S.ciphertext_load(S.ciphertext_save(port, mode), ctx)
            jax, _ = JS.ciphertext_load(JS.ciphertext_save(jax, mode), jctx)
        _same(_arrays(port), _arrays(jax))
        assert P.Decryptor(ctx, objs["sk"]).decrypt(port) == P.Decryptor(ctx, objs["sk"]).decrypt(objs["ct"])
        return
    blob, kind = adversarial[case]
    if kind == "params":
        verdicts = [_verdict(lambda b, c: S.params_load(b), blob, None),
                    _verdict(lambda b, c: JS.params_load(b), blob, None)]
        assert verdicts == ["ValueError", "ValueError"]
        return
    if kind == "sk":
        port, jax = _verdict(S.secret_key_load, blob, ctx), _verdict(JS.secret_key_load, blob, jctx)
        if port == "ValueError":
            assert jax == "ValueError"
        else:
            _same(port, jax)
            with pytest.raises(ValueError):
                P.Decryptor(ctx, S.secret_key_load(blob, ctx)[0])
        return
    if kind == "ct_wrong_context":
        ctx, jctx = _other_contexts()
    port, jax = _verdict(S.ciphertext_load, blob, ctx), _verdict(JS.ciphertext_load, blob, jctx)
    if kind == "ct_data":
        # the blob parses; the data check refuses it in both packages
        _same(port, jax)
        loaded = S.ciphertext_load(blob, ctx)[0]
        assert int(loaded.data.reshape(-1)[0]) == -1               # 2^64 - 1 through int64
        assert V.is_valid_for(loaded, ctx) is False
        assert JV.is_valid_for(JS.ciphertext_load(blob, jctx)[0], jctx) is False
        assert V.is_metadata_valid_for(loaded, ctx) is True
        return
    assert port == jax == "ValueError"


FUZZ_BLOBS = 7


@functools.cache
def _fuzz_blobs():
    ctx, jctx, objs = _client("bfv")
    return ctx, jctx, [
        ("ct", S.ciphertext_save(objs["ct"], S.COMPR_NONE)),
        ("ct", S.ciphertext_save(objs["ct_seeded"], S.COMPR_NONE)),
        ("ct", S.ciphertext_save(objs["ct_seeded"], S.COMPR_ZLIB)),
        ("params", S.params_save(objs["params"], S.COMPR_NONE)),
        ("sk", S.secret_key_save(objs["sk"], S.COMPR_NONE)),
        ("plain", S.plaintext_save(objs["plain_coeff"], S.COMPR_NONE)),
        ("rk", S.kswitch_keys_save(objs["rk_seeded"], ctx, S.COMPR_NONE)),
    ]


FUZZ_LOADERS = {
    "ct": (S.ciphertext_load, JS.ciphertext_load),
    "params": (lambda b, c: S.params_load(b), lambda b, c: JS.params_load(b)),
    "sk": (S.secret_key_load, JS.secret_key_load),
    "plain": (S.plaintext_load, JS.plaintext_load),
    "rk": (lambda b, c: S.kswitch_keys_load(b, c, P.RelinKeys), lambda b, c: JS.kswitch_keys_load(b, c, JaxRelinKeys)),
}


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(which=st.integers(0, FUZZ_BLOBS - 1), cut=st.one_of(st.none(), st.floats(0, 1)),
       flips=st.lists(st.tuples(st.floats(0, 1, exclude_max=True), st.integers(1, 255)), max_size=3),
       head=st.booleans())
def test_fuzz_same_verdict(which, cut, flips, head):
    """Truncations and byte flips (a third of them in the first 100 bytes,
    where the headers and sizes lie): both packages raise ValueError, or
    both load the same object."""
    ctx, jctx, blobs = _fuzz_blobs()
    kind, blob = blobs[which]
    blob = bytearray(blob)
    for where, value in flips:
        pos = int(where * (min(len(blob), 100) if head else len(blob)))
        blob[pos] ^= value
    if cut is not None:
        blob = blob[: int(cut * len(blob))]
    port_load, jax_load = FUZZ_LOADERS[kind]
    port, jax = _verdict(port_load, bytes(blob), ctx), _verdict(jax_load, bytes(blob), jctx)
    if port == "ValueError" or jax == "ValueError":
        assert port == jax
    else:
        _same(port, jax)


# -- (d) valcheck and the evaluator's rejections --------------------------------------------

def _valcheck_cases(ctx, objs):
    """name -> (port object, kwargs) over the cases of tests/test_valcheck.py."""
    ct = objs["ct"]
    wrong_id = ct.copy()
    wrong_id.parms_id = (1, 2, 3, 4)
    key_level = ct.copy()
    key_level.parms_id = ctx.key_parms_id
    full = ct.copy()
    full.data = torch.full_like(ct.data, -1)                    # every residue 2^64 - 1
    at_q, below_q, high_bit = ct.copy(), ct.copy(), ct.copy()
    q0 = ctx.first_context_data().coeff_modulus_values[0]
    for c, v in ((at_q, q0), (below_q, q0 - 1), (high_bit, 1 << 63)):
        c.data = ct.data.clone()
        c.data[1, 0, 7] = v - (1 << 64) if v >= 1 << 63 else v
    t = ctx.first_context_data().parms.plain_modulus.value
    return {
        "valid": (ct, {}), "wrong parms_id": (wrong_id, {}), "key level": (key_level, {}),
        "key level allowed": (key_level, {"allow_pure_key_levels": True}), "every residue 2^64 - 1": (full, {}),
        "a residue equal to q": (at_q, {}), "a residue of q - 1": (below_q, {}), "a residue of 2^63": (high_bit, {}),
        "plain above t": (P.Plaintext.from_coeffs([t + 1]), {}), "plain below t": (P.Plaintext.from_coeffs([t - 1]), {}),
        "plain too long": (P.Plaintext.from_coeffs([1] * (N + 1)), {}), "plain ntt": (objs["plain_ntt"], {}),
        "secret key": (objs["sk"], {}), "public key": (objs["pk"], {}), "empty ciphertext": (P.Ciphertext(), {}),
    }


VALCHECK = ["valid", "wrong parms_id", "key level", "key level allowed", "every residue 2^64 - 1",
            "a residue equal to q", "a residue of q - 1", "a residue of 2^63", "plain above t", "plain below t",
            "plain too long", "plain ntt", "secret key", "public key", "empty ciphertext"]


@pytest.mark.parametrize("case", VALCHECK)
def test_valcheck_same_verdict(clients, case):
    ctx, jctx, objs = clients["bfv"]
    obj, kwargs = _valcheck_cases(ctx, objs)[case]
    if isinstance(obj, P.Ciphertext):
        jobj = JaxCiphertext() if obj.data is None else _jax_ct(obj)
    elif isinstance(obj, P.Plaintext):
        jobj = _jax_pt(obj)
    elif isinstance(obj, P.SecretKey):
        jobj = JaxSecretKey(JU.from_np_u64(C.u64_to_numpy(obj.data)), obj.parms_id)
    else:
        jobj = JaxPublicKey(_jax_ct(obj.data))
    metadata = V.is_metadata_valid_for(obj, ctx, **kwargs)
    assert metadata == JV.is_metadata_valid_for(jobj, jctx, **kwargs)
    assert V.is_valid_for(obj, ctx) == JV.is_valid_for(jobj, jctx)
    if V.is_metadata_valid_for(obj, ctx):
        # the data check reads limbs the metadata promised
        assert V.is_data_valid_for(obj, ctx) == JV.is_data_valid_for(jobj, jctx)
    if case in ("every residue 2^64 - 1", "a residue equal to q", "a residue of 2^63", "plain above t"):
        assert V.is_data_valid_for(obj, ctx) is False
    if case in ("valid", "a residue of q - 1", "plain ntt"):
        assert V.is_valid_for(obj, ctx) is True


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


REJECTIONS = ["add with an NTT-form mismatch", "multiply in NTT form", "add across levels",
              "relinearize to size 3", "rotate_rows by 64", "relinearize without the key",
              "relinearize with keys of another context", "transparent difference"]


@pytest.mark.parametrize("case", REJECTIONS)
def test_evaluator_rejections(clients, case):
    """The evaluator refuses with the JAX package's message (every check
    runs before the JAX package compiles anything, the transparent one
    after one subtraction)."""
    ctx, jctx, objs = clients["bfv"]
    ct, size3, gk = objs["ct"], objs["ct_size3"], objs["gk"]
    lower = objs["ct_switched"]
    ntt = ct.copy()
    ntt.is_ntt_form = True
    empty = P.RelinKeys()
    empty.parms_id, empty.keys = ctx.key_parms_id, [None]
    wrong = P.RelinKeys()
    wrong.parms_id = (9, 9, 9, 9)
    calls = {
        "add with an NTT-form mismatch": lambda ev, c: ev.add(c(ct), c(ntt)),
        "multiply in NTT form": lambda ev, c: ev.multiply(c(ntt), c(ntt)),
        "add across levels": lambda ev, c: ev.add(c(ct), c(lower)),
        "relinearize to size 3": lambda ev, c: ev.relinearize(c(ct), c(objs["rk"]), destination_size=3),
        "rotate_rows by 64": lambda ev, c: ev.rotate_rows(c(ct), 64, c(gk)),
        "relinearize without the key": lambda ev, c: ev.relinearize(c(size3), c(empty)),
        "relinearize with keys of another context": lambda ev, c: ev.relinearize(c(size3), c(wrong)),
        "transparent difference": lambda ev, c: ev.sub(c(ct), c(ct)),
    }

    def carry(obj):
        if isinstance(obj, P.Ciphertext):
            return _jax_ct(obj)
        return _jax_keys(obj, JaxGaloisKeys if isinstance(obj, P.GaloisKeys) else JaxRelinKeys)

    port = _raises(lambda: calls[case](P.Evaluator(ctx), lambda o: o))
    jax = _raises(lambda: calls[case](JaxEvaluator(jctx), carry))
    assert port is not None and port == jax
