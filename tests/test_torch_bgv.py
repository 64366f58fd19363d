"""The port's BGV against the JAX package.

(a) the exact conversion's host constants (``HostBaseConverter`` iratio
    words and Q mod t, ``HostRNSTool.conv_q_to_t``) on three chains;
(b) ``exact_convert_array``, ``decrypt_modt`` and
    ``mod_t_and_divide_q_last_ntt`` (``seal_tpu_torch/ops/rns.py``) against
    the JAX functions on seeded inputs at n <= 2048, and hypothesis cases
    whose CRT value X lies next to 0, Q - 1 and Q / 2: the fraction sum
    then wraps past 2^64, or its rounding half decides;
(c) ``_balance_correction_factors`` over a grid of (f1, f2, t), t prime
    and not;
(d) the client at BGV N=1024, coefficient moduli [50, 50, 50, 50] (three
    data limbs and the special prime), t = ``PlainModulus.batching(1024,
    20)``, ``SecurityLevel.NONE``, a seeded BLAKE2XB factory, host sampling
    on both sides: the keys, secret-key (with and without a saved seed) and
    public-key encryptions of BatchEncoder plaintexts, decryption, decoding
    and ``invariant_noise_budget``, at the first level and after
    ``mod_switch_to_next``;
(e) every method of the BGV ``Evaluator`` surface on those ciphertexts,
    data, level, form and correction factor equal, at the first level and
    (the key switches, the balancing add and sub, the mod switch) after
    ``mod_switch_to_next``; the decoded chain equal to numpy's slot
    arithmetic mod t;
(f) the ``BatchEvaluator`` against the ``Evaluator``; the rejections, with
    the same exception type and message as the JAX package's;
(g) the server request ``golden.bgv_request`` at N=8192
    (``golden.bgv_context``): the port's plain path gives
    ``golden.BGV_DIGEST``; the JAX package's side of it and of
    ``golden.BGV_MEDIUM_DIGEST`` (N=32768), and the port's side of the
    latter, are marked ``slow``.

The JAX package's answers to (d), (e) and the rejections of (f) are frozen
in ``tests/data/jax_answers/`` (``tests/jax_answers.py``); the test marked
``slow`` recomputes them.  Every comparison is exact: BGV is integer
arithmetic.
"""

import functools
import re

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from seal_tpu import evaluator as jax_evaluator
from seal_tpu.context import SealContext as JaxContext
from seal_tpu.data import (Ciphertext as JaxCiphertext, GaloisKeys as JaxGaloisKeys, Plaintext as JaxPlaintext,
                           RelinKeys as JaxRelinKeys)
from seal_tpu.decryptor import Decryptor as JaxDecryptor
from seal_tpu.encoders import BatchEncoder as JaxBatchEncoder
from seal_tpu.encryptor import Encryptor as JaxEncryptor
from seal_tpu.evaluator import Evaluator as JaxEvaluator
from seal_tpu.keygen import KeyGenerator as JaxKeyGenerator
from seal_tpu.modulus import (CoeffModulus as JaxCoeffModulus, Modulus as JaxModulus,
                              PlainModulus as JaxPlainModulus, SecurityLevel as JaxSecurityLevel)
from seal_tpu.ntt_tables import build_limb_tables as jax_build_limb_tables
from seal_tpu.ops import rns as JR
from seal_tpu.ops import u64 as JU
from seal_tpu.params import EncryptionParameters as JaxParameters, SchemeType as JaxScheme
from seal_tpu.random import PRNGType as JaxPRNGType, UniformRandomGeneratorFactory as JaxFactory
from seal_tpu.rns_host import HostRNSBase as JaxBase, HostRNSTool as JaxTool

import seal_tpu_torch as P
from seal_tpu_torch import convert as C
from seal_tpu_torch import evaluator as port_evaluator
from seal_tpu_torch import golden
from seal_tpu_torch.encoders import BatchEncoder
from seal_tpu_torch.modulus import PlainModulus
from seal_tpu_torch.ntt_tables import build_limb_tables
from seal_tpu_torch.ops import rns as R
from seal_tpu_torch.parallel.batch import BatchEvaluator, CiphertextBatch
from seal_tpu_torch.rns_host import HostRNSBase, HostRNSTool

import jax_answers as JA

# -- (a) host constants ------------------------------------------------------------

# (n, coefficient moduli, plain modulus): the default 128-bit chain at
# N=8192 with its batching t, a small chain, and a one-prime chain
CHAINS = {
    "bfv_default(8192)": (8192, lambda: [m.value for m in JaxCoeffModulus.bfv_default(8192)],
                          lambda: JaxPlainModulus.batching(8192, 20).value),
    "small": (1024, lambda: [m.value for m in JaxCoeffModulus.create(1024, [30, 30, 30])],
              lambda: JaxPlainModulus.batching(1024, 16).value),
    "one prime": (1024, lambda: [m.value for m in JaxCoeffModulus.create(1024, [60])],
                  lambda: JaxPlainModulus.batching(1024, 30).value),
}


def _tools(name):
    n, moduli, t = CHAINS[name]
    qs, tv = moduli(), t()
    return (JaxTool(n, JaxBase([JaxModulus(q) for q in qs]), JaxModulus(tv)),
            HostRNSTool(n, HostRNSBase([P.Modulus(q) for q in qs]), P.Modulus(tv)))


def _joined(pair):
    lo, hi = pair
    return [int(v) for v in (lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))).ravel()]


@pytest.mark.parametrize("name", list(CHAINS))
def test_exact_conversion_constants_equal(name):
    jt, pt = _tools(name)
    jc, pc = jt.conv_q_to_t, pt.conv_q_to_t
    assert pc.obase.values == jc.obase.values == [jt.t.value]
    assert pc.matrix == jc.matrix
    d = jc.device()
    assert pc.iratio_lo == _joined(d["iratio_lo"]) and pc.iratio_hi == _joined(d["iratio_hi"])
    assert pc.q_mod_obase0 == d["q_mod_obase0"]
    assert [s % q for s, q in zip(pc.inv_punct, pc.ibase.values)] == [
        int(o) for o in _joined(d["inv_punct_op"])]
    assert pt.inv_q_last_mod_t == jt.inv_q_last_mod_t and pt.q_last_mod_t == jt.q_last_mod_t


# -- (b) the device functions ----------------------------------------------------------

def _jax(fn, x):
    """A JAX package function under ``jax.jit``: at these sizes compiling it
    takes seconds, running its NTTs eagerly tens of seconds."""
    return JU.to_np_u64(jax.jit(fn)(JU.from_np_u64(x)))


def _port(fn, x):
    return C.u64_to_numpy(fn(C.u64_from_numpy(x, "cpu")))


def _residues(rng, values, lead, n):
    q = np.array(values, dtype=np.uint64).reshape(-1, 1)
    return rng.integers(0, 1 << 63, size=(*lead, len(values), n), dtype=np.uint64) % q


def _exact(values, residues, t):
    """The centered CRT value of each column mod t, with Python ints."""
    base = HostRNSBase([P.Modulus(q) for q in values])
    Q = base.base_prod
    return np.array([(x - Q if 2 * x > Q else x) % t for x in base.compose_array(residues)], dtype=np.uint64)


@pytest.mark.parametrize("name", list(CHAINS))
def test_exact_convert_and_decrypt_modt_equal_jax(name):
    jt, pt = _tools(name)
    values = pt.base_q.values
    x = _residues(np.random.default_rng(3), values, (2,), 512)
    want = _jax(lambda a: JR.exact_convert_array(a, jt.conv_q_to_t), x)
    got = _port(lambda a: R.exact_convert_array(a, pt.conv_q_to_t), x)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 1, 512)
    np.testing.assert_array_equal(got[0, 0], _exact(values, x[0], pt.t.value))
    np.testing.assert_array_equal(_port(lambda a: R.decrypt_modt(a, pt), x[0]),
                                  _jax(lambda a: JR.decrypt_modt(a, jt), x[0]))


EDGES = {"zero": lambda Q: 0, "top": lambda Q: Q - 1, "half": lambda Q: Q // 2}


@functools.lru_cache(maxsize=None)
def _edge_case(name):
    """The chain's two tools and the JAX conversion, compiled once."""
    jt, pt = _tools(name)
    return jt, pt, jax.jit(lambda a: JR.exact_convert_array(a, jt.conv_q_to_t))


@settings(max_examples=30, deadline=None)
@given(edge=st.sampled_from(list(EDGES)), name=st.sampled_from(list(CHAINS)),
       offsets=st.lists(st.integers(-(1 << 40), 1 << 40), min_size=16, max_size=16))
def test_exact_convert_at_the_carry_and_rounding_edges(edge, name, offsets):
    """X next to 0 and Q - 1 puts the fraction sum next to a multiple of
    2^64 (it wraps, or stops just short); X next to Q / 2 puts it next to
    the rounding half.  The port equals the JAX package everywhere, and the
    exact centered value mod t outside the fixed point's last bits."""
    jt, pt, jax_convert = _edge_case(name)
    base = pt.base_q
    Q, t = base.base_prod, pt.t.value
    xs = [(EDGES[edge](Q) + o) % Q for o in offsets]
    x = base.decompose_array(np.array(xs, dtype=object))
    got = _port(lambda a: R.exact_convert_array(a, pt.conv_q_to_t), x)
    np.testing.assert_array_equal(got, JU.to_np_u64(jax_convert(JU.from_np_u64(x))))
    # the fixed point errs by at most one unit in 2^64 per fraction
    margin = Q * (base.size + 2) >> 64
    clear = np.array([abs(2 * v - Q) > 2 * margin for v in xs])
    np.testing.assert_array_equal(got[0][clear], _exact(base.values, x, t)[clear])


@pytest.mark.parametrize("n,bits,plain_bits", [(1024, [40, 40, 40], 20), (2048, [60, 50, 60], 24)])
def test_mod_t_and_divide_q_last_ntt_equals_jax(n, bits, plain_bits):
    qs = [m.value for m in JaxCoeffModulus.create(n, bits)]
    tv = JaxPlainModulus.batching(n, plain_bits).value
    jt = JaxTool(n, JaxBase([JaxModulus(q) for q in qs]), JaxModulus(tv))
    pt = HostRNSTool(n, HostRNSBase([P.Modulus(q) for q in qs]), P.Modulus(tv))
    log_n = n.bit_length() - 1
    jtab = jax_build_limb_tables(log_n, [JaxModulus(q) for q in qs])
    ptab = build_limb_tables(log_n, [P.Modulus(q) for q in qs], device="cpu")
    x = _residues(np.random.default_rng(n), qs, (2,), n)
    want = _jax(lambda a: JR.mod_t_and_divide_q_last_ntt(a, jt, jtab), x)
    got = _port(lambda a: R.mod_t_and_divide_q_last_ntt(a, pt, ptab), x)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, len(qs) - 1, n)
    # limbs [1, k - 1) alone, as a rank of a mesh that holds them computes them
    xt = C.u64_from_numpy(x, "cpu")
    part = R.mod_t_and_divide_q_last_ntt_limbs(xt[..., 1:len(qs) - 1, :], xt[..., -1:, :], 1, pt, ptab)
    np.testing.assert_array_equal(C.u64_to_numpy(part), want[..., 1:, :])


# -- (c) correction-factor balancing -------------------------------------------------------

def test_balance_correction_factors_equal_jax():
    cases = 0
    for t in (17, 256, 1000, 65537, 786433, 1032193, (1 << 20) - 3):
        factors = [f for f in (1, 2, 3, 7, 12, 255, 4097, t // 3, t // 2 + 1, t - 2, t - 1) if np.gcd(f, t) == 1]
        for f1 in factors:
            for f2 in factors:
                got = port_evaluator._balance_correction_factors(f1 % t, f2 % t, t)
                assert got == jax_evaluator._balance_correction_factors(f1 % t, f2 % t, t), (f1, f2, t)
                f, e1, e2 = got
                assert f == e1 * f1 % t == e2 * f2 % t
                cases += 1
    assert cases > 300


# -- (d) the client ----------------------------------------------------------------------

N = 1024
BITS = [50, 50, 50, 50]
SEED = (8, 7, 6, 5, 4, 3, 2, 1)
STEPS = [1, -1, 4, 0]          # 0: the column swap; 3 has no key and rotates by NAF [-1, 4]


ANSWERS = JA.Answers(__file__)


def _context(side):
    if side == "jax":
        parms = JaxParameters(JaxScheme.BGV)
        parms.set_poly_modulus_degree(N)
        parms.set_coeff_modulus(JaxCoeffModulus.create(N, BITS))
        parms.set_plain_modulus(JaxPlainModulus.batching(N, 20))
        parms.set_random_generator(JaxFactory(JaxPRNGType.BLAKE2XB, SEED))
        return JaxContext(parms, True, JaxSecurityLevel.NONE)
    parms = P.EncryptionParameters(P.SchemeType.BGV)
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
    assert all(ct.is_ntt_form for level in env["levels"].values() for ct in level)
    switched = env["levels"]["switched"][0]
    cd = env["ctx"].first_context_data()
    assert switched.correction_factor == cd.rns_tool.inv_q_last_mod_t != 1


def _decrypt_case(env):
    dec = env["Decryptor"](env["ctx"], env["keys"]["sk"])
    outs = {}
    for level in ("first", "switched"):
        for name, ct, want in zip("ab", env["levels"][level], (env["va"], env["vb"])):
            plain = dec.decrypt(ct)
            np.testing.assert_array_equal(env["be"].decode(plain), want)
            outs[f"{level} {name}"] = plain
        # the JAX package's inverse NTT of the budget runs eagerly: one
        # ciphertext a level
        outs[f"{level} noise budget"] = budget = dec.invariant_noise_budget(env["levels"][level][1])
        assert budget > 0
    return {f"{level} {name}": ct for level in ("first", "switched") for name, ct in zip("ab", env["levels"][level])}, outs


def test_decrypt_decode_and_noise_budget_equal_jax(env, request):
    ANSWERS.check(request.node.name, *_decrypt_case(env))


# -- (e) the evaluator surface ------------------------------------------------------------

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
    if op in ("add, balancing", "sub, balancing"):
        # the product carries the factor squared, a the factor itself
        prod = ev.relinearize(ev.multiply(a, b), rk)
        return (ev.add if op.startswith("add") else ev.sub)(prod, a)
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
    if op == "multiply_plain ntt x ntt":
        return ev.multiply_plain(a, ev.transform_plain_to_ntt(coeff["general"], a.parms_id))
    if op == "multiply_plain ntt x coeff":
        return ev.multiply_plain(a, coeff["general"])
    if op.startswith("multiply_plain coeff x coeff"):
        return ev.multiply_plain(ev.transform_from_ntt(a), coeff[op.split(", ")[1]])
    if op == "multiply_plain coeff x ntt":
        return ev.multiply_plain(ev.transform_from_ntt(a), ev.transform_plain_to_ntt(coeff["general"], a.parms_id))
    if op == "transform_from_ntt":
        return ev.transform_from_ntt(a)
    if op == "transform_to_ntt":
        return ev.transform_to_ntt(ev.transform_from_ntt(a))
    if op == "mod_switch_to_next":
        return ev.mod_switch_to_next(a)
    if op == "mod_switch_to_next of a product":
        return ev.mod_switch_to_next(ev.relinearize(ev.multiply(a, b), rk))
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


CHEAP = ["negate", "add", "sub", "add_many", "add_plain", "sub_plain", "rotate_rows(0)", "multiply",
         "multiply_plain ntt x ntt", "multiply_plain ntt x coeff", "mod_reduce_to_next"]
FIRST_ONLY = ["square", "multiply_many", "exponentiate", "multiply_plain coeff x coeff, general",
              "multiply_plain coeff x coeff, monomial", "multiply_plain coeff x coeff, negative monomial",
              "multiply_plain coeff x ntt", "transform_from_ntt", "transform_to_ntt", "mod_switch_to the last level",
              "apply_galois", "rotate_rows(3), NAF"]
BOTH = ["relinearize", "rotate_rows(1)", "rotate_columns", "mod_switch_to_next", "mod_switch_to_next of a product"]
SWITCHED_ONLY = ["add, balancing", "sub, balancing"]
CASES = ([("first", op) for op in CHEAP + FIRST_ONLY + BOTH]
         + [("switched", op) for op in CHEAP[:-1] + BOTH + SWITCHED_ONLY])


def _method_case(env, level, op):
    a, b = env["levels"][level]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAL_TPU_DEVICE_SAMPLING", "0")
        out = _run(env, level, op)
    return {"a": a, "b": b, "relin keys": env["keys"]["rk"], "galois keys": env["keys"]["gk"]}, {"out": out}


@pytest.mark.parametrize("level,op", CASES, ids=[f"{lv}-{op}" for lv, op in CASES])
def test_method_equals_jax(env, level, op, request):
    ANSWERS.check(request.node.name, *_method_case(env, level, op))


def test_decoded_chain_is_the_slot_arithmetic(env):
    """x = a and y = b switched down (factor f), z = x y relinearized
    (f^2), w = z + (a + b switched down) balanced, then rotate_rows(1) and
    rotate_columns: decoded, numpy's (a b + a + b) mod t with the rows
    rotated and the columns swapped."""
    pev, t = env["ev"], env["t"]
    dec = P.Decryptor(env["ctx"], env["keys"]["sk"])
    rk, gk = env["keys"]["rk"], env["keys"]["gk"]
    x, y = env["levels"]["switched"]
    z = pev.relinearize(pev.multiply(x, y), rk)
    c = pev.mod_switch_to_next(pev.add(*env["levels"]["first"]))
    assert z.correction_factor != c.correction_factor
    w = pev.rotate_columns(pev.rotate_rows(pev.add(z, c), 1, gk), gk)
    va, vb = (v.astype(object) for v in (env["va"], env["vb"]))
    want = ((va * vb + va + vb) % t).astype(np.uint64)
    rows = np.concatenate([np.roll(want[: N // 2], -1), np.roll(want[N // 2:], -1)])
    assert dec.invariant_noise_budget(w) > 0
    np.testing.assert_array_equal(env["be"].decode(dec.decrypt(w)), np.concatenate([rows[N // 2:], rows[: N // 2]]))
    plain = env["be"].encode(env["vb"])
    np.testing.assert_array_equal(env["be"].decode(dec.decrypt(pev.add_plain(x, plain))),
                                  ((va + vb) % t).astype(np.uint64))
    np.testing.assert_array_equal(env["be"].decode(dec.decrypt(pev.multiply_plain(x, plain))),
                                  (va * vb % t).astype(np.uint64))


# -- (f) the batch evaluator and the rejections -------------------------------------------------

def test_batch_evaluator_equals_the_evaluator(env):
    pev, pctx = env["ev"], env["ctx"]
    bev = BatchEvaluator(pctx)
    rk, gk = env["keys"]["rk"], env["keys"]["gk"]
    a, b = env["levels"]["first"]
    b1, b2 = CiphertextBatch.from_ciphertexts([a, b, a]), CiphertextBatch.from_ciphertexts([b, a, b])
    s1 = bev.mod_switch_to_next(b1)
    coeff = P.Plaintext.from_coeffs(_coeff_plains(env["t"])["general"])
    cases = {
        "multiply": (bev.multiply(b1, b2), lambda x, y: pev.multiply(x, y)),
        "square": (bev.square(b1), lambda x, y: pev.square(x)),
        "relinearize": (bev.relinearize(bev.multiply(b1, b2), rk),
                        lambda x, y: pev.relinearize(pev.multiply(x, y), rk)),
        "mod_switch_to_next": (s1, lambda x, y: pev.mod_switch_to_next(x)),
        "add, balancing": (bev.add(bev.relinearize(bev.multiply(s1, s1), rk), s1),
                           lambda x, y: pev.add(pev.relinearize(pev.square(pev.mod_switch_to_next(x)), rk),
                                                pev.mod_switch_to_next(x))),
        "sub": (bev.sub(b1, b2), lambda x, y: pev.sub(x, y)),
        "negate": (bev.negate(b1), lambda x, y: pev.negate(x)),
        "mod_reduce_to_next": (bev.mod_reduce_to_next(b1), lambda x, y: pev.mod_reduce_to_next(x)),
        "add_plain after mod_switch_to_next": (bev.add_plain(s1, coeff),
                                               lambda x, y: pev.add_plain(pev.mod_switch_to_next(x), coeff)),
        "sub_plain": (bev.sub_plain(b1, coeff), lambda x, y: pev.sub_plain(x, coeff)),
        "multiply_plain ntt x coeff": (bev.multiply_plain(b1, coeff), lambda x, y: pev.multiply_plain(x, coeff)),
        "transform_from_ntt": (bev.transform_from_ntt(b1), lambda x, y: pev.transform_from_ntt(x)),
        "rotate_rows": (bev.rotate_rows(b1, 1, gk), lambda x, y: pev.rotate_rows(x, 1, gk)),
        "rotate_rows, NAF": (bev.rotate_rows(b1, 3, gk), lambda x, y: pev.rotate_rows(x, 3, gk)),
        "rotate_columns": (bev.rotate_columns(b1, gk), lambda x, y: pev.rotate_columns(x, gk)),
        "the request": (golden.bgv_request(bev, b1, b2, rk, gk),
                        lambda x, y: golden.bgv_request(pev, x, y, rk, gk)),
        "multiply_many": (bev.multiply_many([b1, b2, b1], rk),
                          lambda x, y: pev.multiply_many([x, y, x], rk)),
    }
    for name, (batch, single) in cases.items():
        for r in range(batch.batch_size):
            want = single(b1[r], b2[r])
            got = batch[r]
            assert torch.equal(got.data, want.data), name
            assert (got.parms_id, got.is_ntt_form, got.scale, got.correction_factor) == (
                want.parms_id, want.is_ntt_form, want.scale, want.correction_factor), name


def _rejections(env):
    ev, keys, ctx = env["ev"], env["keys"], env["ctx"]
    Enc, Dec = env["Encryptor"], env["Decryptor"]
    a, b = env["levels"]["first"]
    coeff_ct = ev.transform_from_ntt(a)
    coeff = env["Plaintext"].from_coeffs([1, 2, 3])
    ntt_plain = ev.transform_plain_to_ntt(coeff, a.parms_id)
    rk, gk = keys["rk"], keys["gk"]
    return {
        "multiply: coefficient form": (lambda: ev.multiply(coeff_ct, coeff_ct),
                                       "encrypted1 and encrypted2 must be in NTT form"),
        "add_plain: coefficient ciphertext": (lambda: ev.add_plain(coeff_ct, coeff), "BGV encrypted must be in NTT form"),
        "sub_plain: NTT plaintext": (lambda: ev.sub_plain(a, ntt_plain), "BGV plain cannot be in NTT form"),
        "relinearize: coefficient form": (lambda: ev.relinearize(ev.transform_from_ntt(ev.multiply(a, b)), rk),
                                          "BGV encrypted must be in NTT form"),
        "apply_galois: coefficient form": (lambda: ev.apply_galois(coeff_ct, 3, gk),
                                           "BGV encrypted must be in NTT form"),
        "mod_switch_to_next: coefficient form": (lambda: ev.mod_switch_to_next(coeff_ct),
                                                 "BGV encrypted must be in NTT form"),
        "mod_switch_to_next: end of chain": (lambda: ev.mod_switch_to_next(ev.mod_switch_to(a, ctx.last_parms_id)),
                                             "end of modulus switching chain reached"),
        "rotate_rows: no key, no NAF": (lambda: ev.rotate_rows(a, 2, gk), "Galois key not present"),
        "rotate_vector: BGV": (lambda: ev.rotate_vector(a, 1, gk), "unsupported scheme"),
        "complex_conjugate: BGV": (lambda: ev.complex_conjugate(a, gk), "unsupported scheme"),
        "rescale_to_next: BGV": (lambda: ev.rescale_to_next(a), "unsupported scheme"),
        "multiply_many: empty": (lambda: ev.multiply_many([], rk), "encrypteds cannot be empty"),
        "exponentiate: 0": (lambda: ev.exponentiate(a, 0, rk), "exponent cannot be 0"),
        "encrypt: NTT plaintext": (lambda: Enc(ctx, secret_key=keys["sk"]).encrypt_symmetric(ntt_plain),
                                   "plain cannot be in NTT form"),
        "decrypt: coefficient form": (lambda: Dec(ctx, keys["sk"]).decrypt(coeff_ct), "encrypted must be in NTT form"),
        "noise budget: coefficient form": (lambda: Dec(ctx, keys["sk"]).invariant_noise_budget(coeff_ct),
                                           "BGV encrypted must be in NTT form"),
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
    coeff = bev.transform_from_ntt(batch)
    plain = P.Plaintext.from_coeffs([1])
    gk, rk = env["keys"]["gk"], env["keys"]["rk"]
    for fn, message in ((lambda: bev.multiply(coeff, coeff), "BGV operands must be in NTT form"),
                        (lambda: bev.add_plain(coeff, plain), "BGV encrypted must be in NTT form"),
                        (lambda: bev.mod_switch_to_next(coeff), "BGV encrypted must be in NTT form"),
                        (lambda: bev.relinearize(bev.transform_from_ntt(bev.multiply(batch, batch)), rk),
                         "BGV encrypted must be in NTT form"),
                        (lambda: bev.rotate_rows(coeff, 1, gk), "BGV encrypted must be in NTT form"),
                        (lambda: bev.rescale_to_next(batch), "unsupported scheme"),
                        (lambda: bev.rotate_vector(batch, 1, gk), "unsupported scheme"),
                        (lambda: bev.multiply_many([], rk), "encrypteds cannot be empty")):
        with pytest.raises(ValueError, match=re.escape(message)):
            fn()


# -- (g) the server request -----------------------------------------------------------------------

def _request_inputs(ctx):
    n = ctx.first_context_data().parms.poly_modulus_degree
    d1, d2 = golden.request_inputs(ctx, golden.GOLDEN_REQUEST_SEED)
    galois = [None] * n
    galois[golden.BGV_GALOIS_ELT >> 1] = golden.galois_key_inputs(ctx, golden.BGV_GALOIS_SEED)
    return d1, d2, golden.key_inputs(ctx, golden.GOLDEN_KEY_SEED), galois


def _port_request(n):
    ctx = golden.bgv_context(n, device="cpu")
    d1, d2, relin, galois = _request_inputs(ctx)
    cts = [C.ciphertext_from_numpy(d, ctx.first_parms_id, True, 1.0, "cpu") for d in (d1, d2)]
    out = golden.bgv_request(P.Evaluator(ctx), *cts, C.relin_keys_from_numpy([relin], ctx.key_parms_id, "cpu"),
                             C.galois_keys_from_numpy(galois, ctx.key_parms_id, "cpu"))
    return ctx, out


def test_port_request_gives_bgv_digest():
    ctx, out = _port_request(golden.BGV_N)
    cd = ctx.first_context_data()
    assert cd.parms.plain_modulus.value == 1032193 and len(cd.coeff_modulus_values) == 4
    assert out.parms_id == cd.next_context_data.parms_id and out.is_ntt_form
    assert out.correction_factor == golden.BGV_CORRECTION_FACTOR == cd.rns_tool.inv_q_last_mod_t
    assert ctx.key_context_data().rns_tool.inv_q_last_mod_t != out.correction_factor   # the tail's constant
    data = C.u64_to_numpy(out.data)
    assert data.shape == (2, 3, golden.BGV_N)
    assert golden.digest(data) == golden.BGV_DIGEST


def _jax_bgv_request(n):
    jp = JaxParameters(JaxScheme.BGV)
    jp.set_poly_modulus_degree(n)
    jp.set_coeff_modulus(JaxCoeffModulus.bfv_default(n))
    jp.set_plain_modulus(JaxPlainModulus.batching(n, golden.BFV_PLAIN_BITS))
    jctx = JaxContext(jp, True, JaxSecurityLevel.TC128)
    pctx = golden.bgv_context(n, device="cpu")
    assert jctx.first_parms_id == pctx.first_parms_id
    d1, d2, relin, galois = _request_inputs(pctx)
    rk, gk = JaxRelinKeys(), JaxGaloisKeys()
    rk.parms_id, rk.keys = jctx.key_parms_id, [{"c0": JU.from_np_u64(relin[0]), "c1": JU.from_np_u64(relin[1])}]
    gk.parms_id = jctx.key_parms_id
    gk.keys = [None if g is None else {"c0": JU.from_np_u64(g[0]), "c1": JU.from_np_u64(g[1])} for g in galois]
    cts = [JaxCiphertext(data=JU.from_np_u64(d), parms_id=jctx.first_parms_id, is_ntt_form=True) for d in (d1, d2)]
    out = golden.bgv_request(JaxEvaluator(jctx), *cts, rk, gk)
    return golden.digest(JU.to_np_u64(out.data)), out.correction_factor


@pytest.mark.slow
def test_jax_request_gives_bgv_digest():
    assert _jax_bgv_request(golden.BGV_N) == (golden.BGV_DIGEST, golden.BGV_CORRECTION_FACTOR)


@pytest.mark.slow
def test_jax_request_gives_bgv_medium_digest():
    assert _jax_bgv_request(golden.BGV_MEDIUM_N) == (golden.BGV_MEDIUM_DIGEST, golden.BGV_MEDIUM_CORRECTION_FACTOR)


@pytest.mark.slow
def test_port_request_gives_bgv_medium_digest():
    ctx, out = _port_request(golden.BGV_MEDIUM_N)
    data = C.u64_to_numpy(out.data)
    assert data.shape == (2, 14, golden.BGV_MEDIUM_N)
    assert out.correction_factor == golden.BGV_MEDIUM_CORRECTION_FACTOR
    assert golden.digest(data) == golden.BGV_MEDIUM_DIGEST


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
