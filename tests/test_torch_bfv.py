"""The port's BFV client, evaluator and batch evaluator against the JAX package.

BFV N=1024, coefficient moduli [40, 40, 40] (two data limbs and the special
prime), t = ``PlainModulus.batching(1024, 20)``, ``SecurityLevel.NONE``, a
seeded BLAKE2XB factory, host sampling on both sides:

(a) the client: the secret, public, relinearization and Galois keys
    (rows, and columns: element 2N - 1) of each package's KeyGenerator
    equal; secret-key (with and without a saved seed) and public-key
    encryptions of BatchEncoder plaintexts from the same seed equal;
    decryption, decoding and ``invariant_noise_budget`` equal, the decoded
    slots the encoded ones;
(b) every method of the BFV surface (negate, add, sub, add_many, multiply,
    square, relinearize, multiply_many, exponentiate, the modulus switches,
    add_plain, sub_plain, multiply_plain on its coefficient branches and
    with an NTT plaintext, the NTT transforms, apply_galois, rotate_rows
    with and without a NAF decomposition, rotate_columns), at the first
    level and, for the multiply and the rotations, after
    ``mod_switch_to_next``: data, level and form equal; the decoded product
    equal to the slot-wise product mod t;
(c) the ``BatchEvaluator``'s BFV methods on a batch of those ciphertexts,
    equal to the port's ``Evaluator`` one ciphertext at a time;
(d) the reference's rejections, with the same exception type and message;
(e) the server request ``build_bfv_mult_relin`` at N=8192
    (``golden.bfv_context``): the port's plain path gives
    ``golden.BFV_DIGEST``; the JAX package's side of it and of
    ``golden.BFV_MEDIUM_DIGEST`` (N=32768, ~4 minutes) is marked ``slow``.

The JAX package's answers to (a), (b) and (d) are frozen in
``tests/data/jax_answers/`` (``tests/jax_answers.py``); the test marked
``slow`` recomputes them.  Every comparison is exact: BFV is integer
arithmetic.
"""

import re

import jax
import numpy as np
import pytest
import torch

from seal_tpu.context import SealContext as JaxContext
from seal_tpu.data import Plaintext as JaxPlaintext
from seal_tpu.decryptor import Decryptor as JaxDecryptor
from seal_tpu.encoders import BatchEncoder as JaxBatchEncoder
from seal_tpu.encryptor import Encryptor as JaxEncryptor
from seal_tpu.evaluator import Evaluator as JaxEvaluator
from seal_tpu.keygen import KeyGenerator as JaxKeyGenerator
from seal_tpu.modulus import (CoeffModulus as JaxCoeffModulus, PlainModulus as JaxPlainModulus,
                              SecurityLevel as JaxSecurityLevel)
from seal_tpu.ops import u64 as JU
from seal_tpu.params import EncryptionParameters as JaxParameters, SchemeType as JaxScheme
from seal_tpu.pipeline import build_bfv_mult_relin as jax_bfv_pipeline
from seal_tpu.random import PRNGType as JaxPRNGType, UniformRandomGeneratorFactory as JaxFactory

import seal_tpu_torch as P
from seal_tpu_torch import convert as C
from seal_tpu_torch import golden
from seal_tpu_torch.encoders import BatchEncoder
from seal_tpu_torch.modulus import PlainModulus
from seal_tpu_torch.parallel.batch import BatchEvaluator, CiphertextBatch
from seal_tpu_torch.pipeline import build_bfv_mult_relin

import jax_answers as JA

N = 1024
BITS = [40, 40, 40]
SEED = (8, 7, 6, 5, 4, 3, 2, 1)
STEPS = [1, -1, 4, 0]          # 0: the column swap; 3 has no key and rotates by NAF [-1, 4]


ANSWERS = JA.Answers(__file__)


def _context(side):
    if side == "jax":
        parms = JaxParameters(JaxScheme.BFV)
        parms.set_poly_modulus_degree(N)
        parms.set_coeff_modulus(JaxCoeffModulus.create(N, BITS))
        parms.set_plain_modulus(JaxPlainModulus.batching(N, 20))
        parms.set_random_generator(JaxFactory(JaxPRNGType.BLAKE2XB, SEED))
        return JaxContext(parms, True, JaxSecurityLevel.NONE)
    parms = P.EncryptionParameters(P.SchemeType.BFV)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(P.CoeffModulus.create(N, BITS))
    parms.set_plain_modulus(PlainModulus.batching(N, 20))
    parms.set_random_generator(P.UniformRandomGeneratorFactory(P.PRNGType.BLAKE2XB, SEED))
    return P.SealContext(parms, True, P.SecurityLevel.NONE, device="cpu")


def _client(side, ctx, va, vb):
    """Keys, two ciphertexts (secret key; public key) and a seeded one."""
    KG, Enc, Be = ((JaxKeyGenerator, JaxEncryptor, JaxBatchEncoder) if side == "jax"
                   else (P.KeyGenerator, P.Encryptor, BatchEncoder))
    kg = KG(ctx)
    keys = {"sk": kg.secret_key, "pk": kg.create_public_key(), "rk": kg.create_relin_keys(),
            "gk": kg.create_galois_keys_from_steps(STEPS)}
    be = Be(ctx)
    sym = Enc(ctx, secret_key=keys["sk"])
    a = sym.encrypt_symmetric(be.encode(va))
    seeded = sym.encrypt_symmetric(be.encode(vb), save_seed=True)
    # the seeded factory repeats its stream: the second operand comes from
    # the public key, with another c1
    b = Enc(ctx, public_key=keys["pk"]).encrypt(be.encode(vb))
    return keys, be, a, b, seeded


def _env(side):
    """One package's context, keys, encoder, evaluator, and per level the
    two ciphertexts, from its own client; host sampling."""
    ctx = _context(side)
    t = ctx.first_context_data().parms.plain_modulus.value
    rng = np.random.default_rng(5)
    va = rng.integers(0, t, size=N, dtype=np.uint64)
    vb = rng.integers(0, t, size=N, dtype=np.uint64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAL_TPU_DEVICE_SAMPLING", "0")
        keys, be, a, b, seeded = _client(side, ctx, va, vb)
    is_jax = side == "jax"
    ev = (JaxEvaluator if is_jax else P.Evaluator)(ctx)
    levels = {"first": (a, b), "switched": (ev.mod_switch_to_next(a), ev.mod_switch_to_next(b))}
    return {"side": side, "ctx": ctx, "ev": ev, "keys": keys, "be": be, "va": va, "vb": vb, "t": t,
            "seeded": seeded, "levels": levels, "Plaintext": JaxPlaintext if is_jax else P.Plaintext,
            "Encryptor": JaxEncryptor if is_jax else P.Encryptor,
            "Decryptor": JaxDecryptor if is_jax else P.Decryptor}


@pytest.fixture(scope="module")
def env():
    """The port's side, built by its own client."""
    return _env("port")


# -- (a) the client ----------------------------------------------------------------

def _keys_case(env):
    keys = env["keys"]
    return {"seed": np.array(SEED, dtype=np.uint64)}, {
        "secret key": keys["sk"], "public key": keys["pk"], "relin keys": keys["rk"], "galois keys": keys["gk"]}


def test_keys_equal_jax(env, request):
    ANSWERS.check(request.node.name, *_keys_case(env))
    assert env["keys"]["gk"].has_key(2 * N - 1) and env["keys"]["gk"].has_key(3)


def _encryptions_case(env):
    outs = {f"{level} {name}": ct for level in ("first", "switched")
            for name, ct in zip("ab", env["levels"][level])}
    outs["seeded"] = env["seeded"]
    outs["seed"] = np.array(env["seeded"].seed_info.seed, dtype=np.uint64)
    return {"a": env["va"], "b": env["vb"]}, outs


def test_encryptions_equal_jax(env, request):
    ANSWERS.check(request.node.name, *_encryptions_case(env))
    assert not any(ct.is_ntt_form for level in env["levels"].values() for ct in level)


def _decrypt_case(env):
    dec = env["Decryptor"](env["ctx"], env["keys"]["sk"])
    outs = {}
    for level in ("first", "switched"):
        for name, ct, want in zip("ab", env["levels"][level], (env["va"], env["vb"])):
            plain = dec.decrypt(ct)
            np.testing.assert_array_equal(env["be"].decode(plain), want)
            outs[f"{level} {name}"] = plain
            outs[f"{level} {name} noise budget"] = budget = dec.invariant_noise_budget(ct)
            assert budget > 0
    return {f"{level} {name}": ct for level in ("first", "switched") for name, ct in zip("ab", env["levels"][level])}, outs


def test_decrypt_decode_and_noise_budget_equal_jax(env, request):
    ANSWERS.check(request.node.name, *_decrypt_case(env))


# -- (b) the evaluator surface ------------------------------------------------------

def _coeff_plains(t):
    """A general coefficient plaintext, a monomial, and a monomial whose
    coefficient lies in the upper half (a negative value)."""
    general = (np.arange(N, dtype=np.uint64) * np.uint64(2654435761)) % np.uint64(t)
    mono = np.zeros(N, dtype=np.uint64)
    mono[5] = 3
    neg = np.zeros(N, dtype=np.uint64)
    neg[N - 1] = np.uint64(t - 2)
    return {"general": general, "monomial": mono, "negative monomial": neg}


def _run(env, level, op):
    ev, ctx = env["ev"], env["ctx"]
    gk, rk = env["keys"]["gk"], env["keys"]["rk"]
    a, b = env["levels"][level]
    PT = env["Plaintext"]
    coeff = {name: PT.from_coeffs(v) for name, v in _coeff_plains(env["t"]).items()}
    if op == "negate":
        return ev.negate(a)
    if op == "add":
        return ev.add(a, b)
    if op == "sub":
        return ev.sub(a, b)
    if op == "add_many":
        return ev.add_many([a, b, a])
    if op == "multiply":
        return ev.multiply(a, b)
    if op == "square":
        return ev.square(a)
    if op == "relinearize":
        return ev.relinearize(ev.multiply(a, b), rk)
    if op == "multiply_many":
        return ev.multiply_many([a, b, a], rk)
    if op == "exponentiate":
        return ev.exponentiate(b, 3, rk)
    if op == "add_plain":
        return ev.add_plain(a, coeff["general"])
    if op == "sub_plain":
        return ev.sub_plain(a, coeff["negative monomial"])
    if op.startswith("multiply_plain coeff x coeff"):
        return ev.multiply_plain(a, coeff[op.split(", ")[1]])
    if op == "multiply_plain coeff x ntt":
        return ev.multiply_plain(a, ev.transform_plain_to_ntt(coeff["general"], a.parms_id))
    if op == "transform_to_ntt":
        return ev.transform_to_ntt(a)
    if op == "transform_from_ntt":
        return ev.transform_from_ntt(ev.transform_to_ntt(a))
    if op == "mod_switch_to_next":
        return ev.mod_switch_to_next(a)
    if op == "mod_switch_to the last level":
        return ev.mod_switch_to(a, ctx.last_parms_id)
    if op == "mod_reduce_to_next":
        return ev.mod_reduce_to_next(a)
    if op == "apply_galois":
        return ev.apply_galois(a, 3, gk)
    if op == "rotate_rows(1)":
        return ev.rotate_rows(a, 1, gk)
    if op == "rotate_rows(3), NAF":
        return ev.rotate_rows(a, 3, gk)
    if op == "rotate_rows(0)":
        return ev.rotate_rows(a, 0, gk)
    if op == "rotate_columns":
        return ev.rotate_columns(a, gk)
    raise AssertionError(op)


CHEAP = ["negate", "add", "sub", "add_many", "add_plain", "sub_plain", "rotate_rows(0)"]
FIRST_ONLY = ["multiply", "square", "multiply_many", "exponentiate", "multiply_plain coeff x coeff, general",
              "multiply_plain coeff x coeff, monomial", "multiply_plain coeff x coeff, negative monomial",
              "multiply_plain coeff x ntt", "transform_to_ntt", "transform_from_ntt", "mod_switch_to_next",
              "mod_switch_to the last level", "mod_reduce_to_next", "apply_galois", "rotate_rows(3), NAF"]
BOTH = ["relinearize", "rotate_rows(1)", "rotate_columns"]
CASES = ([("first", op) for op in CHEAP + FIRST_ONLY + BOTH] + [("switched", op) for op in CHEAP + BOTH])


def _method_case(env, level, op):
    a, b = env["levels"][level]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAL_TPU_DEVICE_SAMPLING", "0")
        out = _run(env, level, op)
    return {"a": a, "b": b, "relin keys": env["keys"]["rk"], "galois keys": env["keys"]["gk"]}, {"out": out}


@pytest.mark.parametrize("level,op", CASES, ids=[f"{lv}-{op}" for lv, op in CASES])
def test_method_equals_jax(env, level, op, request):
    ANSWERS.check(request.node.name, *_method_case(env, level, op))


def test_decoded_results_are_the_slot_arithmetic(env):
    """The port's own results decode to the slot-wise arithmetic mod t, with
    rows rotated and columns swapped."""
    pev, t = env["ev"], np.uint64(env["t"])
    dec = P.Decryptor(env["ctx"], env["keys"]["sk"])
    a, b = env["levels"]["first"]
    va, vb = env["va"], env["vb"]
    rk, gk = env["keys"]["rk"], env["keys"]["gk"]
    prod = (va.astype(object) * vb.astype(object) % int(t)).astype(np.uint64)
    out = pev.relinearize(pev.multiply(a, b), rk)
    rows = lambda v, s: np.concatenate([np.roll(v[: N // 2], -s), np.roll(v[N // 2:], -s)])
    cols = lambda v: np.concatenate([v[N // 2:], v[: N // 2]])
    chain = pev.mod_switch_to_next(pev.rotate_columns(pev.rotate_rows(out, 1, gk), gk))
    assert dec.invariant_noise_budget(chain) > 0
    np.testing.assert_array_equal(env["be"].decode(dec.decrypt(out)), prod)
    np.testing.assert_array_equal(env["be"].decode(dec.decrypt(chain)), cols(rows(prod, 1)))
    np.testing.assert_array_equal(env["be"].decode(dec.decrypt(pev.add_plain(a, env["be"].encode(vb)))),
                                  (va + vb) % t)


# -- (c) the batch evaluator ----------------------------------------------------------

def test_batch_evaluator_equals_the_evaluator(env):
    pev, pctx = env["ev"], env["ctx"]
    bev = BatchEvaluator(pctx)
    rk, gk = env["keys"]["rk"], env["keys"]["gk"]
    a, b = env["levels"]["first"]
    b1, b2 = CiphertextBatch.from_ciphertexts([a, b, a]), CiphertextBatch.from_ciphertexts([b, a, a])
    plain = P.Plaintext.from_coeffs(_coeff_plains(env["t"])["general"])
    cases = {
        "multiply": (bev.multiply(b1, b2), lambda x, y: pev.multiply(x, y)),
        "square": (bev.square(b1), lambda x, y: pev.square(x)),
        "relinearize": (bev.relinearize(bev.multiply(b1, b2), rk),
                        lambda x, y: pev.relinearize(pev.multiply(x, y), rk)),
        "mod_switch_to_next": (bev.mod_switch_to_next(b1), lambda x, y: pev.mod_switch_to_next(x)),
        "mod_reduce_to_next": (bev.mod_reduce_to_next(b1), lambda x, y: pev.mod_reduce_to_next(x)),
        "add_plain": (bev.add_plain(b1, plain), lambda x, y: pev.add_plain(x, plain)),
        "sub_plain": (bev.sub_plain(b1, plain), lambda x, y: pev.sub_plain(x, plain)),
        "multiply_plain": (bev.multiply_plain(b1, plain), lambda x, y: pev.multiply_plain(x, plain)),
        "rotate_rows": (bev.rotate_rows(b1, 1, gk), lambda x, y: pev.rotate_rows(x, 1, gk)),
        "rotate_rows, NAF": (bev.rotate_rows(b1, 3, gk), lambda x, y: pev.rotate_rows(x, 3, gk)),
        "rotate_columns": (bev.rotate_columns(b1, gk), lambda x, y: pev.rotate_columns(x, gk)),
        "rotate_rows after mod_switch_to_next": (bev.rotate_rows(bev.mod_switch_to_next(b1), 1, gk),
                                                 lambda x, y: pev.rotate_rows(pev.mod_switch_to_next(x), 1, gk)),
        "multiply_many": (bev.multiply_many([b1, b2, b1], rk),
                          lambda x, y: pev.multiply_many([x, y, x], rk)),
    }
    for name, (batch, single) in cases.items():
        for r in range(batch.batch_size):
            want = single(b1[r], b2[r])
            got = batch[r]
            assert torch.equal(got.data, want.data), name
            assert (got.parms_id, got.is_ntt_form, got.scale) == (want.parms_id, want.is_ntt_form, want.scale), name


# -- (d) rejections --------------------------------------------------------------------

def _rejections(env):
    ev, keys, ctx, side = env["ev"], env["keys"], env["ctx"], env["side"]
    Enc, Dec = env["Encryptor"], env["Decryptor"]
    Be = JaxBatchEncoder if side == "jax" else BatchEncoder
    a, b = env["levels"]["first"]
    ntt = ev.transform_to_ntt(a)
    coeff = env["Plaintext"].from_coeffs([1, 2, 3])
    ntt_plain = ev.transform_plain_to_ntt(coeff, a.parms_id)
    rk, gk = keys["rk"], keys["gk"]
    return {
        "multiply: NTT form": (lambda: ev.multiply(ntt, ntt), "encrypted1 or encrypted2 cannot be in NTT form"),
        "add_plain: NTT ciphertext": (lambda: ev.add_plain(ntt, coeff), "BFV operands cannot be in NTT form"),
        "sub_plain: NTT plaintext": (lambda: ev.sub_plain(a, ntt_plain), "BFV operands cannot be in NTT form"),
        "relinearize: NTT form": (lambda: ev.relinearize(ev.transform_to_ntt(ev.multiply(a, b)), rk),
                                  "BFV encrypted cannot be in NTT form"),
        "apply_galois: NTT form": (lambda: ev.apply_galois(ntt, 3, gk), "BFV encrypted cannot be in NTT form"),
        "mod_switch_to_next: NTT form": (lambda: ev.mod_switch_to_next(ntt), "BFV encrypted cannot be in NTT form"),
        "mod_switch_to_next: end of chain": (lambda: ev.mod_switch_to_next(ev.mod_switch_to(a, ctx.last_parms_id)),
                                             "end of modulus switching chain reached"),
        "rotate_rows: no key, no NAF": (lambda: ev.rotate_rows(a, 2, gk), "Galois key not present"),
        "rotate_vector: BFV": (lambda: ev.rotate_vector(a, 1, gk), "unsupported scheme"),
        "complex_conjugate: BFV": (lambda: ev.complex_conjugate(a, gk), "unsupported scheme"),
        "rescale_to_next: BFV": (lambda: ev.rescale_to_next(a), "unsupported scheme"),
        "multiply_many: empty": (lambda: ev.multiply_many([], rk), "encrypteds cannot be empty"),
        "exponentiate: 0": (lambda: ev.exponentiate(a, 0, rk), "exponent cannot be 0"),
        "encrypt: NTT plaintext": (lambda: Enc(ctx, secret_key=keys["sk"]).encrypt_symmetric(ntt_plain),
                                   "plain cannot be in NTT form"),
        "decrypt: NTT form": (lambda: Dec(ctx, keys["sk"]).decrypt(ntt), "encrypted cannot be in NTT form"),
        "noise budget: NTT form": (lambda: Dec(ctx, keys["sk"]).invariant_noise_budget(ntt),
                                   "BFV encrypted cannot be in NTT form"),
        "decode: NTT plaintext": (lambda: Be(ctx).decode(ntt_plain), "plain cannot be in NTT form"),
    }


def _rejection_case(env):
    """Each rejection's message, where the call raises ValueError with the
    reference's message."""
    outs = {}
    for name, (fn, message) in _rejections(env).items():
        with pytest.raises(ValueError, match=re.escape(message)):
            fn()
        outs[name] = message
    return {"a": env["levels"]["first"][0]}, outs


def test_rejections_equal_jax(env, request):
    ANSWERS.check(request.node.name, *_rejection_case(env))


def test_batch_rejections(env):
    bev = BatchEvaluator(env["ctx"])
    a, b = env["levels"]["first"]
    batch = CiphertextBatch.from_ciphertexts([a, b])
    ntt = bev.transform_to_ntt(batch)
    plain = P.Plaintext.from_coeffs([1])
    for fn, message in ((lambda: bev.multiply(ntt, ntt), "BFV operands cannot be in NTT form"),
                        (lambda: bev.add_plain(ntt, plain), "BFV operands cannot be in NTT form"),
                        (lambda: bev.mod_switch_to_next(ntt), "BFV encrypted cannot be in NTT form"),
                        (lambda: bev.relinearize(bev.transform_to_ntt(bev.multiply(batch, batch)),
                                                 env["keys"]["rk"]), "BFV encrypted cannot be in NTT form"),
                        (lambda: bev.rotate_rows(ntt, 1, env["keys"]["gk"]), "BFV encrypted cannot be in NTT form"),
                        (lambda: bev.rescale_to_next(batch), "unsupported scheme"),
                        (lambda: bev.rotate_vector(batch, 1, env["keys"]["gk"]), "unsupported scheme"),
                        (lambda: bev.multiply_many([], env["keys"]["rk"]), "encrypteds cannot be empty")):
        with pytest.raises(ValueError, match=re.escape(message)):
            fn()


# -- (e) the server request ----------------------------------------------------------

def _request(ctx):
    d1, d2 = golden.request_inputs(ctx, golden.GOLDEN_REQUEST_SEED)
    kc0, kc1 = golden.key_inputs(ctx, golden.GOLDEN_KEY_SEED)
    return d1, d2, kc0, kc1


def test_port_pipeline_gives_bfv_digest():
    ctx = golden.bfv_context(golden.BFV_N, device="cpu")
    cd = ctx.first_context_data()
    assert cd.parms.plain_modulus.value == 1032193 and len(cd.coeff_modulus_values) == 4
    assert cd.rns_tool.base_Bsk.size == 5
    out = C.u64_to_numpy(build_bfv_mult_relin(ctx)(*(C.u64_from_numpy(a, "cpu") for a in _request(ctx))))
    assert out.shape == (2, 4, golden.BFV_N)
    assert golden.digest(out) == golden.BFV_DIGEST


def _jax_bfv_digest(n):
    jp = JaxParameters(JaxScheme.BFV)
    jp.set_poly_modulus_degree(n)
    jp.set_coeff_modulus(JaxCoeffModulus.bfv_default(n))
    jp.set_plain_modulus(JaxPlainModulus.batching(n, golden.BFV_PLAIN_BITS))
    jctx = JaxContext(jp, True, JaxSecurityLevel.TC128)
    pctx = golden.bfv_context(n, device="cpu")
    assert jctx.first_parms_id == pctx.first_parms_id
    out = jax.jit(jax_bfv_pipeline(jctx))(*(JU.from_np_u64(a) for a in _request(pctx)))
    return golden.digest(JU.to_np_u64(out))


@pytest.mark.slow
def test_jax_pipeline_gives_bfv_digest():
    assert _jax_bfv_digest(golden.BFV_N) == golden.BFV_DIGEST


@pytest.mark.slow
def test_jax_pipeline_gives_bfv_medium_digest():
    assert _jax_bfv_digest(golden.BFV_MEDIUM_N) == golden.BFV_MEDIUM_DIGEST


def answers(side):
    """(case id, inputs, outputs) of every case that reads frozen answers."""
    env = _env(side)
    yield ("test_keys_equal_jax", *_keys_case(env))
    yield ("test_encryptions_equal_jax", *_encryptions_case(env))
    yield ("test_decrypt_decode_and_noise_budget_equal_jax", *_decrypt_case(env))
    for level, op in CASES:
        yield (f"test_method_equals_jax[{level}-{op}]", *_method_case(env, level, op))
    yield ("test_rejections_equal_jax", *_rejection_case(env))


@pytest.mark.slow
def test_frozen_answers_equal_the_jax_package():
    JA.check_twin(__file__, answers("jax"), answers("port"))
