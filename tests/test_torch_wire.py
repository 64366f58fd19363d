"""The wire path: Microsoft SEAL's blobs, and a request served over the wire.

(a) SEAL's own blobs (``tests/data/wire``, written by the reference with a
    fixed BLAKE2XB seed; the port's side of ``tests/test_wire_compat.py``):
    the port's fixed-seed keys equal them byte for byte, the reference's
    ciphertexts (full, seeded, zlib, zstd, N=4096) decrypt to the
    manifest's values, the reference's keys serve, and every loaded tensor
    lies on the context's device;
(b) the slice as a whole at N=1024, for CKKS (multiply -> relinearize ->
    rescale_to_next), BFV (multiply -> relinearize) and BGV
    (``golden.bgv_request``): the port's client, from the JAX client's
    seeded factory and through the same Encryptor setters, makes the JAX
    client's request bytes (parameters, keys, a seeded secret-key and a
    public-key encryption); the port serves two requests on the CPU
    (loads, ``valcheck.is_valid_for``, the evaluator, saves), and its reply
    bytes equal the JAX package's; the client decrypts the replies to the
    expected slots, and the plaintexts equal the JAX client's;
    ``decrypt_batch`` over the replies and over the requests equals the JAX
    package's and mapped ``decrypt``;
(c) ``Evaluator(ctx, throw_on_transparent=False)`` and the module flag, as
    in the JAX package, and the constructor's parameters.

The JAX package's side of (b) and (c), on host sampling
(``SEAL_TPU_DEVICE_SAMPLING=0``), is frozen in ``tests/data/jax_answers/``
(``tests/jax_answers.py``); the test marked ``slow`` recomputes it.
"""

import inspect
import os

import numpy as np
import pytest

from seal_tpu import evaluator as jax_evaluator
from seal_tpu import serialization as JS
from seal_tpu.ckks_encoder import CKKSEncoder as JaxCKKSEncoder
from seal_tpu.context import SealContext as JaxContext
from seal_tpu.data import GaloisKeys as JaxGaloisKeys, RelinKeys as JaxRelinKeys
from seal_tpu.decryptor import Decryptor as JaxDecryptor
from seal_tpu.encoders import BatchEncoder as JaxBatchEncoder
from seal_tpu.encryptor import Encryptor as JaxEncryptor
from seal_tpu.evaluator import Evaluator as JaxEvaluator
from seal_tpu.keygen import KeyGenerator as JaxKeyGenerator
from seal_tpu.modulus import (CoeffModulus as JaxCoeffModulus, PlainModulus as JaxPlainModulus,
                              SecurityLevel as JaxSecurityLevel)
from seal_tpu.ops import u64 as JU
from seal_tpu.parallel.batch import CiphertextBatch as JaxBatch
from seal_tpu.params import EncryptionParameters as JaxParameters, SchemeType as JaxScheme
from seal_tpu.random import PRNGType as JaxPRNGType, UniformRandomGeneratorFactory as JaxFactory

import seal_tpu_torch as P
from seal_tpu_torch import convert as C
from seal_tpu_torch import evaluator as port_evaluator
from seal_tpu_torch import golden
from seal_tpu_torch import serialization as S
from seal_tpu_torch import valcheck as V
from seal_tpu_torch.parallel.batch import CiphertextBatch

import jax_answers as JA

DATA = os.path.join(os.path.dirname(__file__), "data", "wire")
FIXED_SEED = tuple(0x1111111111111111 * (i + 1) for i in range(8))


def _blob(name: str) -> bytes:
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


def _manifest() -> dict:
    out = {"ckks_vals": {}, "bfv4096_rot_slots": {}}
    with open(os.path.join(DATA, "manifest.txt")) as f:
        for line in f:
            key, _, rest = line.strip().partition(" ")
            if key in ("ckks_val", "bfv4096_rot_slot"):
                idx, val = rest.split(" ", 1)
                out[key + "s"][int(idx)] = float(val) if key == "ckks_val" else int(val)
            elif key.endswith("_hex"):
                out[key] = rest
    return out


MANIFEST = _manifest()
_CONTEXTS = {}


def _context(name: str) -> P.SealContext:
    """A CPU context from ``<name>_parms.bin`` with the blobs' fixed seed."""
    if name not in _CONTEXTS:
        parms, _ = S.params_load(_blob(f"{name}_parms.bin"))
        parms.set_random_generator(P.UniformRandomGeneratorFactory(P.PRNGType.BLAKE2XB, FIXED_SEED))
        sec = P.SecurityLevel.TC128 if name == "bfv4096" else P.SecurityLevel.NONE
        _CONTEXTS[name] = P.SealContext(parms, True, sec, device="cpu")
    return _CONTEXTS[name]


def _load(kind, name, ctx):
    """Load a blob whole, and check where it landed."""
    raw = _blob(name)
    loaders = {"ct": S.ciphertext_load, "sk": S.secret_key_load, "pk": S.public_key_load,
               "rk": lambda b, c: S.kswitch_keys_load(b, c, P.RelinKeys),
               "gk": lambda b, c: S.kswitch_keys_load(b, c, P.GaloisKeys), "pt": S.plaintext_load}
    obj, used = loaders[kind](raw, ctx)
    assert used == len(raw)
    tensors = {"ct": lambda o: [o.data], "sk": lambda o: [o.data], "pk": lambda o: [o.data.data],
               "pt": lambda o: [o.rns_data] if o.is_ntt_form else [],
               "rk": lambda o: [t for e in o.keys if e is not None for t in (e["c0"], e["c1"])]}
    tensors["gk"] = tensors["rk"]
    assert all(t.device == ctx.device for t in tensors[kind](obj))
    if kind in ("ct", "pt", "pk"):
        assert V.is_valid_for(obj, ctx)
    return obj


# -- (a) Microsoft SEAL's blobs ---------------------------------------------------------

@pytest.mark.parametrize("name", ["bfv", "bgv", "ckks", "bfv4096"])
def test_params_byte_identical(name):
    raw = _blob(f"{name}_parms.bin")
    parms, used = S.params_load(raw)
    assert used == len(raw) and S.params_save(parms, S.COMPR_NONE) == raw
    assert S.params_save(_context(name).key_context_data().parms, S.COMPR_NONE) == raw


@pytest.mark.parametrize("name", ["bfv", "bgv", "ckks", "bfv4096"])
def test_fixed_seed_secret_key_byte_identical(name):
    assert S.secret_key_save(P.KeyGenerator(_context(name)).secret_key, S.COMPR_NONE) == _blob(f"{name}_sk.bin")


@pytest.mark.parametrize("name,key", [("bfv", "pk"), ("bfv", "rlk"), ("bfv", "glk"), ("bfv4096", "pk"),
                                      ("bfv4096", "glk")])
def test_fixed_seed_keys_byte_identical(name, key):
    """Every encryption of zero of keygen on the blobs' PRNG stream, the
    secret key's powers and the KSwitchKeys container (the Galois keys'
    empty entries included), equal to the reference's bytes."""
    ctx = _context(name)
    kg = P.KeyGenerator(ctx)
    if key == "pk":
        got = S.public_key_save(kg.create_public_key(), S.COMPR_NONE)
    elif key == "rlk":
        got = S.kswitch_keys_save(kg.create_relin_keys(), ctx, S.COMPR_NONE)
    else:
        steps = [1, -1] if name == "bfv" else [1]
        got = S.kswitch_keys_save(kg.create_galois_keys_from_steps(steps), ctx, S.COMPR_NONE)
    assert got == _blob(f"{name}_{key}.bin")


@pytest.mark.parametrize("blob", ["bfv_ct", "bfv_ct_seeded", "bfv_ct_zlib", "bfv_ct_zstd", "bgv_ct", "bgv_ct_seeded",
                                  "bfv_ct_prod"])
def test_reference_ciphertext_decrypts(blob):
    if blob.endswith("zstd") and not S._HAS_ZSTD:
        pytest.skip("zstandard is not installed")
    scheme = blob.split("_")[0]
    ctx = _context(scheme)
    sk = _load("sk", f"{scheme}_sk.bin", ctx)
    ct = _load("ct", f"{blob}.bin", ctx)
    want = MANIFEST["bfv_prod_hex" if blob == "bfv_ct_prod" else f"{scheme}_pt_hex"]
    assert P.Decryptor(ctx, sk).decrypt(ct).to_string() == want
    if blob in ("bfv_ct_zlib", "bfv_ct_zstd"):
        assert S.ciphertext_save(ct, S.COMPR_NONE) == _blob("bfv_ct.bin")
    if blob.endswith("seeded"):
        assert len(_blob(f"{blob}.bin")) < 0.7 * len(_blob(f"{scheme}_ct.bin"))


def test_reference_plaintext_and_compressed_secret_keys():
    ctx = _context("bfv")
    pt = _load("pt", "bfv_pt.bin", ctx)
    assert pt.to_string() == MANIFEST["bfv_pt_hex"]
    assert S.plaintext_save(pt, S.COMPR_NONE) == _blob("bfv_pt.bin")
    for name in ("bfv_sk_zlib.bin",) + (("bfv_sk_zstd.bin",) if S._HAS_ZSTD else ()):
        assert S.secret_key_save(_load("sk", name, ctx), S.COMPR_NONE) == _blob("bfv_sk.bin")


@pytest.mark.parametrize("rlk", ["bfv_rlk", "bfv_rlk_seeded"])
def test_reference_relin_keys_serve(rlk):
    ctx = _context("bfv")
    sk, ct = _load("sk", "bfv_sk.bin", ctx), _load("ct", "bfv_ct.bin", ctx)
    rk = _load("rk", f"{rlk}.bin", ctx)
    ev = P.Evaluator(ctx)
    out = ev.add(ev.relinearize(ev.multiply(ct, ct), rk), ct)
    assert P.Decryptor(ctx, sk).decrypt(out).to_string() == MANIFEST["bfv_prod_hex"]


@pytest.mark.parametrize("glk", ["bfv_glk", "bfv_glk_seeded"])
def test_reference_galois_keys_serve(glk):
    ctx = _context("bfv")
    sk = _load("sk", "bfv_sk.bin", ctx)
    gk = _load("gk", f"{glk}.bin", ctx)
    enc = P.BatchEncoder(ctx)
    vals = np.arange(enc.slots, dtype=np.uint64) % 17
    ct = P.Encryptor(ctx, secret_key=sk).encrypt_symmetric(enc.encode(vals))
    out = enc.decode(P.Decryptor(ctx, sk).decrypt(P.Evaluator(ctx).rotate_rows(ct, 1, gk)))
    half = enc.slots // 2
    np.testing.assert_array_equal(out, np.concatenate([np.roll(vals[:half], -1), np.roll(vals[half:], -1)]))


@pytest.mark.parametrize("blob", ["bfv4096_ct", "bfv4096_ct_zlib", "bfv4096_ct_zstd"])
def test_reference_4096_ciphertext_rotates(blob):
    if blob.endswith("zstd") and not S._HAS_ZSTD:
        pytest.skip("zstandard is not installed")
    ctx = _context("bfv4096")
    sk, gk = _load("sk", "bfv4096_sk.bin", ctx), _load("gk", "bfv4096_glk.bin", ctx)
    ct = _load("ct", f"{blob}.bin", ctx)
    assert S.ciphertext_save(ct, S.COMPR_NONE) == _blob("bfv4096_ct.bin")
    out = P.BatchEncoder(ctx).decode(P.Decryptor(ctx, sk).decrypt(P.Evaluator(ctx).rotate_rows(ct, 1, gk)))
    for i, v in MANIFEST["bfv4096_rot_slots"].items():
        assert out[i] == v


@pytest.mark.parametrize("blob", ["ckks_pt", "ckks_ct", "ckks_ct_seeded"])
def test_reference_ckks_decodes(blob):
    ctx = _context("ckks")
    if blob == "ckks_pt":
        pt, tol = _load("pt", "ckks_pt.bin", ctx), 1e-4
    else:
        pt, tol = P.Decryptor(ctx, _load("sk", "ckks_sk.bin", ctx)).decrypt(_load("ct", f"{blob}.bin", ctx)), 1e-3
    vals = P.CKKSEncoder(ctx).decode(pt)
    for i, v in MANIFEST["ckks_vals"].items():
        assert abs(vals[i].real - v) < tol and abs(vals[i].imag) < tol


@pytest.mark.parametrize("scheme", ["bfv", "bgv", "ckks"])
def test_reference_public_keys_encrypt(scheme):
    """The reference's public key, loaded, encrypts what its secret key decrypts."""
    ctx = _context(scheme)
    sk, pk = _load("sk", f"{scheme}_sk.bin", ctx), _load("pk", f"{scheme}_pk.bin", ctx)
    dec = P.Decryptor(ctx, sk)
    if scheme == "ckks":
        enc = P.CKKSEncoder(ctx)
        v = np.linspace(-1, 1, enc.slot_count)
        got = enc.decode(dec.decrypt(P.Encryptor(ctx, public_key=pk).encrypt(enc.encode(v, 2.0 ** 30))))
        assert np.max(np.abs(got.real - v)) < 1e-3
    else:
        pt = P.Plaintext.from_hex("7x^4 + 3x^2 + 2x^1 + 9")
        assert dec.decrypt(P.Encryptor(ctx, public_key=pk).encrypt(pt)) == pt


# -- (b) the slice as a whole over the wire ------------------------------------------------

N = 1024
SLICE = {  # scheme: (coefficient moduli bits, plain modulus bits)
    "ckks": ([60, 40, 40, 60], None),
    "bfv": ([50, 50, 50], 20),
    "bgv": ([50, 50, 50, 50], 20),
}
SLICE_SEED = (31, 32, 33, 34, 35, 36, 37, 38)
SCALE = 2.0 ** 40


def _slice_parms(pkg, scheme):
    Params, Scheme, Coeff, Plain, Factory, PRNG = pkg
    bits, t = SLICE[scheme]
    p = Params(getattr(Scheme, scheme.upper()))
    p.set_poly_modulus_degree(N)
    p.set_coeff_modulus(Coeff.create(N, bits))
    if t:
        p.set_plain_modulus(Plain.batching(N, t))
    p.set_random_generator(Factory(PRNG.BLAKE2XB, SLICE_SEED))
    return p


JAX_PKG = (JaxParameters, JaxScheme, JaxCoeffModulus, JaxPlainModulus, JaxFactory, JaxPRNGType)
PORT_PKG = (P.EncryptionParameters, P.SchemeType, P.CoeffModulus, P.PlainModulus, P.UniformRandomGeneratorFactory,
            P.PRNGType)


def _slots(scheme, t):
    rng = np.random.default_rng(9)
    if scheme == "ckks":
        return rng.uniform(-1, 1, N // 2), rng.uniform(-1, 1, N // 2)
    return rng.integers(0, t, N, dtype=np.uint64), rng.integers(0, t, N, dtype=np.uint64)


def _client_bytes(side, scheme):
    """(client objects, request bytes) of the JAX package or the port: the
    parameters, a relinearization key and (BGV) a Galois key saved with
    their seeds, a seeded secret-key encryption (zstd where installed) and
    a public-key encryption (zlib)."""
    jax = side == "jax"
    pkg = JAX_PKG if jax else PORT_PKG
    parms = _slice_parms(pkg, scheme)
    Context, Sec = (JaxContext, JaxSecurityLevel) if jax else (P.SealContext, P.SecurityLevel)
    ctx = Context(parms, True, Sec.NONE) if jax else Context(parms, True, Sec.NONE, device="cpu")
    ser = JS if jax else S
    kg = (JaxKeyGenerator if jax else P.KeyGenerator)(ctx)
    sk, pk = kg.secret_key, kg.create_public_key()
    encryptor = (JaxEncryptor if jax else P.Encryptor)(ctx, public_key=pk)
    encryptor.set_secret_key(sk)
    t = None if scheme == "ckks" else ctx.first_context_data().parms.plain_modulus.value
    va, vb = _slots(scheme, t)
    if scheme == "ckks":
        enc = (JaxCKKSEncoder if jax else P.CKKSEncoder)(ctx)
        pa, pb = enc.encode(va, SCALE), enc.encode(vb, SCALE)
    else:
        enc = (JaxBatchEncoder if jax else P.BatchEncoder)(ctx)
        pa, pb = enc.encode(va), enc.encode(vb)
    a = encryptor.encrypt_symmetric(pa, save_seed=True)
    b = encryptor.encrypt(pb)
    request = {
        "params": ser.params_save(parms, ser.COMPR_NONE),
        "rk": ser.kswitch_keys_save(kg.create_relin_keys(save_seed=True), ctx, ser.COMPR_NONE),
        "a": ser.ciphertext_save(a, ser.COMPR_MODE_DEFAULT),
        "b": ser.ciphertext_save(b, ser.COMPR_ZLIB),
    }
    if scheme == "bgv":
        request["gk"] = ser.kswitch_keys_save(kg.create_galois_keys_from_steps([1], save_seed=True), ctx,
                                              ser.COMPR_ZLIB)
    return {"ctx": ctx, "sk": sk, "enc": enc, "va": va, "vb": vb, "t": t}, request


def _step(scheme, ev, x, y, rk, gk):
    if scheme == "ckks":
        return ev.rescale_to_next(ev.relinearize(ev.multiply(x, y), rk))
    if scheme == "bfv":
        return ev.relinearize(ev.multiply(x, y), rk)
    return golden.bgv_request(ev, x, y, rk, gk)


def _serve(side, scheme, request):
    """Load the request, check it, serve (a, b) and (b, a), save the
    replies.  Returns (reply bytes, the loaded a and b)."""
    jax = side == "jax"
    ser = JS if jax else S
    parms, _ = ser.params_load(request["params"])
    ctx = JaxContext(parms, True, JaxSecurityLevel.NONE) if jax else P.SealContext(parms, True, P.SecurityLevel.NONE,
                                                                                   device="cpu")
    rk, _ = ser.kswitch_keys_load(request["rk"], ctx, JaxRelinKeys if jax else P.RelinKeys)
    gk = ser.kswitch_keys_load(request["gk"], ctx, JaxGaloisKeys if jax else P.GaloisKeys)[0] if "gk" in request \
        else None
    a, _ = ser.ciphertext_load(request["a"], ctx)
    b, _ = ser.ciphertext_load(request["b"], ctx)
    if not jax:
        assert V.is_valid_for(a, ctx) and V.is_valid_for(b, ctx) and a.seed_info is None
        assert rk.keys[0]["seeds"] is None and a.data.device == ctx.device
    ev = (JaxEvaluator if jax else P.Evaluator)(ctx)
    replies = [ser.ciphertext_save(_step(scheme, ev, x, y, rk, gk), ser.COMPR_ZLIB) for x, y in ((a, b), (b, a))]
    return replies, (a, b)


def _expected(scheme, client):
    va, vb = client["va"], client["vb"]
    if scheme == "ckks":
        return va * vb
    prod = va * vb % np.uint64(client["t"])
    if scheme == "bfv":
        return prod
    half = N // 2
    return np.concatenate([np.roll(prod[:half], -1), np.roll(prod[half:], -1)])


ANSWERS = JA.Answers(__file__)


def _side(side, scheme):
    """One package's client, request, replies and loaded request, each on
    its own bytes; the JAX package on host sampling."""
    with pytest.MonkeyPatch.context() as mp:
        if side == "jax":
            mp.setenv("SEAL_TPU_DEVICE_SAMPLING", "0")
        client, request = _client_bytes(side, scheme)
        replies, loaded = _serve(side, scheme, request)
    return {"scheme": scheme, "side": side, "client": client, "request": request, "replies": replies,
            "loaded": loaded}


@pytest.fixture(scope="module", params=list(SLICE))
def wire(request):
    """The port's side: its client's request, served by the port."""
    return _side("port", request.param)


def _plain(p):
    return {"values": _plain_values(p), "parms_id": np.array(p.parms_id, dtype=np.uint64), "scale": p.scale}


def _request_case(w):
    return {"seed": np.array(SLICE_SEED, dtype=np.uint64)}, w["request"]


def _reply_case(w):
    return w["request"], {f"reply {i}": r for i, r in enumerate(w["replies"])}


def _decrypt_case(w):
    """The client decrypts each reply (the integers before decoding)."""
    client = w["client"]
    jax = w["side"] == "jax"
    dec = (JaxDecryptor if jax else P.Decryptor)(client["ctx"], client["sk"])
    outs = {}
    for i, reply in enumerate(w["replies"]):
        ct, _ = (JS if jax else S).ciphertext_load(reply, client["ctx"])
        plain = dec.decrypt(ct)
        got = client["enc"].decode(plain)
        want = _expected(w["scheme"], client)
        if w["scheme"] == "ckks":
            assert np.max(np.abs(got.real - want)) < 1e-5
        else:
            np.testing.assert_array_equal(got, want)
        outs.update({f"reply {i} {k}": v for k, v in _plain(plain).items()})
    return _reply_case(w)[1], outs


def _decrypt_batch(w, what):
    """The ciphertexts, their decryptor and its ``decrypt_batch`` of them."""
    client = w["client"]
    jax = w["side"] == "jax"
    if what == "replies":
        cts = [(JS if jax else S).ciphertext_load(r, client["ctx"])[0] for r in w["replies"]]
    else:
        cts = list(w["loaded"])
    dec = (JaxDecryptor if jax else P.Decryptor)(client["ctx"], client["sk"])
    return cts, dec, dec.decrypt_batch((JaxBatch if jax else CiphertextBatch).from_ciphertexts(cts))


def _decrypt_batch_case(w, what, decrypted=None):
    cts, _, got = decrypted or _decrypt_batch(w, what)
    assert len(got) == 2
    outs = {f"{i} {k}": v for i, g in enumerate(got) for k, v in _plain(g).items()}
    return {f"ciphertext {i}": c for i, c in enumerate(cts)}, outs


def _transparent_case(w, switch):
    """sub(ct, ct) is transparent: with the check off it is returned."""
    jax = w["side"] == "jax"
    module, Ev = (jax_evaluator, JaxEvaluator) if jax else (port_evaluator, P.Evaluator)
    a, ctx = w["loaded"][0], w["client"]["ctx"]
    with pytest.MonkeyPatch.context() as mp:
        if switch == "argument":
            ev = Ev(ctx, throw_on_transparent=False)
        else:
            mp.setattr(module, "THROW_ON_TRANSPARENT", False)
            ev = Ev(ctx)
        got = ev.sub(a, a)
    assert got.is_transparent()
    return {"a": a}, {"out": got}


def test_request_bytes_equal(wire, request):
    """The port's client (keygen, the Encryptor setters, encoding and both
    encryptions) makes the JAX client's bytes."""
    ANSWERS.check(request.node.name, *_request_case(wire))


def test_reply_bytes_equal(wire, request):
    ANSWERS.check(request.node.name, *_reply_case(wire))


def test_jax_client_decrypts_port_reply(wire, request):
    """The client decrypts the replies to the expected slots, and its
    plaintexts equal the JAX client's.  Here the port's client decrypts and
    the JAX client's plaintexts are the frozen record; the ``slow`` twin
    has the JAX client decrypt the JAX replies.  The id is kept from when
    this test ran the JAX client on the port's replies."""
    ANSWERS.check(request.node.name, *_decrypt_case(wire))


def _plain_values(p):
    if isinstance(p, P.Plaintext):
        return p.to_string() if not p.is_ntt_form else C.u64_to_numpy(p.rns_data)
    return p.to_string() if not p.is_ntt_form else JU.to_np_u64(p.rns_data)


@pytest.mark.parametrize("what", ["replies", "requests"])
def test_decrypt_batch(wire, what, request):
    """The port's decrypt_batch equals the JAX package's and mapped decrypt,
    over the two replies (BGV: a correction factor other than 1 after the
    modulus switch) and over the two loaded requests."""
    decrypted = _decrypt_batch(wire, what)
    ANSWERS.check(request.node.name, *_decrypt_batch_case(wire, what, decrypted))
    pcts, pdec, got = decrypted
    mapped = [pdec.decrypt(c) for c in pcts]
    assert len(got) == len(mapped) == 2
    for g, m in zip(got, mapped):
        assert g.parms_id == m.parms_id and g.scale == m.scale
        np.testing.assert_array_equal(_plain_values(g), _plain_values(m))
    if wire["scheme"] == "bgv" and what == "replies":
        assert pcts[0].correction_factor != 1


def test_decrypt_batch_rejections(wire):
    pclient = wire["client"]
    a, b = wire["loaded"]
    dec = P.Decryptor(pclient["ctx"], pclient["sk"])
    batch = CiphertextBatch.from_ciphertexts([a, b])
    batch.is_ntt_form = not batch.is_ntt_form
    with pytest.raises(ValueError, match="NTT form"):
        dec.decrypt_batch(batch)
    batch = CiphertextBatch.from_ciphertexts([a, b])
    batch.data = batch.data[:, :1]
    with pytest.raises(ValueError, match="empty"):
        dec.decrypt_batch(batch)


# -- (c) throw_on_transparent ---------------------------------------------------------------

def test_evaluator_constructor_takes_the_jax_parameters():
    port = list(inspect.signature(P.Evaluator.__init__).parameters.values())
    jax = list(inspect.signature(JaxEvaluator.__init__).parameters.values())
    assert [(p.name, p.default) for p in port] == [(p.name, p.default) for p in jax]
    assert port_evaluator.THROW_ON_TRANSPARENT is jax_evaluator.THROW_ON_TRANSPARENT is True


@pytest.mark.parametrize("switch", ["argument", "module flag"])
def test_transparent_results_without_the_check(wire, switch, request):
    """sub(ct, ct) is transparent: the default evaluator raises, one with the
    check off returns it, as in the JAX package."""
    a = wire["loaded"][0]
    with pytest.raises(ValueError, match="transparent"):
        P.Evaluator(wire["client"]["ctx"]).sub(a, a)
    ANSWERS.check(request.node.name, *_transparent_case(wire, switch))


def answers(side):
    """(case id, inputs, outputs) of every case that reads frozen answers."""
    for scheme in SLICE:
        w = _side(side, scheme)
        yield (f"test_request_bytes_equal[{scheme}]", *_request_case(w))
        yield (f"test_reply_bytes_equal[{scheme}]", *_reply_case(w))
        yield (f"test_jax_client_decrypts_port_reply[{scheme}]", *_decrypt_case(w))
        for what in ("replies", "requests"):
            yield (f"test_decrypt_batch[{scheme}-{what}]", *_decrypt_batch_case(w, what))
        for switch in ("argument", "module flag"):
            yield (f"test_transparent_results_without_the_check[{scheme}-{switch}]", *_transparent_case(w, switch))


@pytest.mark.slow
def test_frozen_answers_equal_the_jax_package():
    JA.check_twin(__file__, answers("jax"), answers("port"))
