"""The port's CKKS evaluator surface against the JAX package, on real encryptions.

CKKS N=1024, bits [60, 40, 40, 40, 60], ``SecurityLevel.NONE``, the seeded
BLAKE2XB factory; each package encodes and encrypts with its own client
(host sampling, host ladder), and the digests of the port's inputs equal the
JAX package's, so both evaluators see the same bits:

(d) every method of the surface (negate, add, sub, add_many, square, the
    modulus switches, add_plain, sub_plain, multiply_plain on all four
    branches, the NTT transforms, apply_galois, rotate_vector with and
    without a NAF decomposition, complex_conjugate) on ciphertexts at the
    first level, after ``mod_switch_to_next`` and after ``rescale_to_next``
    (the last two at the same level, at different scales): data, level,
    scale and NTT form equal; public-key encryption below the first level;
(e) the reference's rejections, with the same exception type and message;
(h) the port's Evaluator has every method of the JAX package's.

The JAX package's answers to (d) and (e) are frozen in
``tests/data/jax_answers/`` (``tests/jax_answers.py``); the test marked
``slow`` recomputes them, compiling each op once per level (about 12 s on
the CPU for a key switch or a rescale).  The cheap ops run at every level,
the rotations at the first level and after ``mod_switch_to_next`` (where the
Galois key is trimmed to fewer rows), and the rest at the first level;
``rescale_to`` is held to the port's ``rescale_to_next``.  Every comparison
is exact.
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from seal_tpu.ckks_encoder import CKKSEncoder as JaxEncoder
from seal_tpu.context import SealContext as JaxContext
from seal_tpu.data import Plaintext as JaxPlaintext
from seal_tpu.encryptor import Encryptor as JaxEncryptor
from seal_tpu.evaluator import Evaluator as JaxEvaluator
from seal_tpu.keygen import KeyGenerator as JaxKeyGenerator
from seal_tpu.modulus import CoeffModulus as JaxCoeffModulus, SecurityLevel as JaxSecurityLevel
from seal_tpu.params import EncryptionParameters as JaxParameters, SchemeType as JaxScheme
from seal_tpu.random import PRNGType as JaxPRNGType, UniformRandomGeneratorFactory as JaxFactory

import seal_tpu_torch as P
from seal_tpu_torch import convert as C

import jax_answers as JA

N = 1024
BITS = [60, 40, 40, 40, 60]
SEED = (1, 2, 3, 4, 5, 6, 7, 8)
SCALE = 2.0 ** 40
STEPS = [1, -1, 4, 0]          # 0: the conjugation; 3 has no key and rotates by NAF [-1, 4]


ANSWERS = JA.Answers(__file__)
HOST_PATHS = ("SEAL_TPU_DEVICE_SAMPLING", "SEAL_TPU_DEVICE_FFT", "SEAL_TPU_DEVICE_COMPOSE")


def _package(side):
    if side == "jax":
        return SimpleNamespace(Parameters=JaxParameters, Scheme=JaxScheme, CoeffModulus=JaxCoeffModulus,
                               Context=lambda parms: JaxContext(parms, True, JaxSecurityLevel.NONE),
                               Factory=JaxFactory, PRNGType=JaxPRNGType, KeyGenerator=JaxKeyGenerator,
                               Encoder=JaxEncoder, Encryptor=JaxEncryptor, Evaluator=JaxEvaluator,
                               Plaintext=JaxPlaintext)
    return SimpleNamespace(Parameters=P.EncryptionParameters, Scheme=P.SchemeType, CoeffModulus=P.CoeffModulus,
                           Context=lambda parms: P.SealContext(parms, True, P.SecurityLevel.NONE, device="cpu"),
                           Factory=P.UniformRandomGeneratorFactory, PRNGType=P.PRNGType, KeyGenerator=P.KeyGenerator,
                           Encoder=P.CKKSEncoder, Encryptor=P.Encryptor, Evaluator=P.Evaluator, Plaintext=P.Plaintext)


def _env(side):
    """One package's context, evaluator and keys from the seeded factory,
    and per level two ciphertexts and a plaintext of the ciphertexts'
    scale; host sampling and the host ladder."""
    k = _package(side)
    with pytest.MonkeyPatch.context() as mp:
        for var in HOST_PATHS:
            mp.setenv(var, "0")
        parms = k.Parameters(k.Scheme.CKKS)
        parms.set_poly_modulus_degree(N)
        parms.set_coeff_modulus(k.CoeffModulus.create(N, BITS))
        parms.set_random_generator(k.Factory(k.PRNGType.BLAKE2XB, SEED))
        ctx = k.Context(parms)
        kg = k.KeyGenerator(ctx)
        gk, rk, pk = kg.create_galois_keys_from_steps(STEPS), kg.create_relin_keys(), kg.create_public_key()
        enc = k.Encoder(ctx)
        slots = np.arange(N // 2)
        pt = enc.encode(np.cos(slots / 7.0) + 0.25j * np.sin(slots / 5.0), SCALE)
        # the seeded factory repeats its stream, so the second ciphertext
        # comes from the public key (another c1)
        a = k.Encryptor(ctx, secret_key=kg.secret_key).encrypt_symmetric(pt)
        b = k.Encryptor(ctx, public_key=pk).encrypt(enc.encode(np.linspace(-1.0, 1.0, N // 2), SCALE))
    ev = k.Evaluator(ctx)
    nxt = ctx.first_context_data().next_context_data.parms_id
    levels = {"first": (a, b, pt),
              "switched": (ev.mod_switch_to_next(a), ev.mod_switch_to_next(b), ev.mod_switch_plain_to(pt, nxt))}
    # after rescale_to_next the plaintext's scale is the products' over
    # q_last, the ciphertexts'
    low = ev.mod_switch_plain_to(pt, nxt)
    low.scale = SCALE * SCALE / ctx.first_context_data().coeff_modulus_values[-1]
    levels["rescaled"] = (*(ev.rescale_to_next(ev.multiply_plain(x, pt)) for x in (a, b)), low)
    return {"side": side, "ctx": ctx, "ev": ev, "gk": gk, "rk": rk, "pk": pk, "Plaintext": k.Plaintext,
            "levels": levels}


@pytest.fixture(scope="module")
def env():
    """The port's side, built by its own client."""
    return _env("port")


def _coeff_plains(n):
    """A general coefficient plaintext, a monomial, and a monomial whose
    coefficient lies in the upper half (a negative value)."""
    general = (np.arange(n, dtype=np.uint64) * np.uint64(2654435761)) % np.uint64(1 << 20)
    mono = np.zeros(n, dtype=np.uint64)
    mono[5] = 3
    neg = np.zeros(n, dtype=np.uint64)
    neg[n - 1] = np.uint64((1 << 64) - 2)
    return {"general": general, "monomial": mono, "negative monomial": neg}


def _run(env, level, op):
    ev, gk = env["ev"], env["gk"]
    a, b, pt = env["levels"][level]
    PT = env["Plaintext"]
    coeff = {name: PT.from_coeffs(v) for name, v in _coeff_plains(N).items()}
    for p in coeff.values():
        p.scale = 2.0 ** 10
    if op == "negate":
        return ev.negate(a)
    if op == "add":
        return ev.add(a, b)
    if op == "sub":
        return ev.sub(a, b)
    if op == "add_many":
        return ev.add_many([a, b, a])
    if op == "square":
        return ev.square(a)
    if op == "add of sizes 3 and 2":
        b2 = b.copy()
        b2.scale = a.scale * a.scale
        return ev.add(ev.square(a), b2)
    if op == "add_plain":
        return ev.add_plain(a, pt)
    if op == "sub_plain":
        return ev.sub_plain(a, pt)
    if op == "multiply_plain ntt x ntt":
        return ev.multiply_plain(a, pt)
    if op == "multiply_plain ntt x coeff":
        return ev.multiply_plain(a, coeff["general"])
    if op == "multiply_plain coeff x ntt":
        return ev.multiply_plain(ev.transform_from_ntt(a), pt)
    if op.startswith("multiply_plain coeff x coeff"):
        return ev.multiply_plain(ev.transform_from_ntt(a), coeff[op.split(", ")[1]])
    if op == "transform_plain_to_ntt":
        return ev.transform_plain_to_ntt(coeff["general"], a.parms_id)
    if op == "transform_from_ntt":
        return ev.transform_from_ntt(a)
    if op == "transform_to_ntt":
        return ev.transform_to_ntt(ev.transform_from_ntt(a))
    if op == "mod_switch_to_next":
        return ev.mod_switch_to_next(a)
    if op == "mod_reduce_to_next":
        return ev.mod_reduce_to_next(a)
    if op == "mod_switch_plain_to":
        return ev.mod_switch_plain_to(pt, env["ctx"].last_parms_id)
    if op == "mod_switch_to the last level":
        return ev.mod_switch_to(a, env["ctx"].last_parms_id)
    if op == "mod_reduce_to the last level":
        return ev.mod_reduce_to(a, env["ctx"].last_parms_id)
    if op == "apply_galois":
        return ev.apply_galois(a, 3, gk)
    if op == "rotate_vector(1)":
        return ev.rotate_vector(a, 1, gk)
    if op == "rotate_vector(3), NAF":
        return ev.rotate_vector(a, 3, gk)
    if op == "rotate_vector(0)":
        return ev.rotate_vector(a, 0, gk)
    if op == "complex_conjugate":
        return ev.complex_conjugate(a, gk)
    raise AssertionError(op)


CHEAP = ["negate", "add", "sub", "add_many", "add_plain", "sub_plain", "multiply_plain ntt x ntt",
         "mod_switch_to_next", "mod_reduce_to_next", "mod_switch_plain_to", "rotate_vector(0)"]
FIRST_ONLY = ["square", "add of sizes 3 and 2", "multiply_plain ntt x coeff", "multiply_plain coeff x ntt",
              "multiply_plain coeff x coeff, general", "multiply_plain coeff x coeff, monomial",
              "multiply_plain coeff x coeff, negative monomial", "transform_plain_to_ntt",
              "transform_from_ntt", "transform_to_ntt", "mod_switch_to the last level",
              "mod_reduce_to the last level", "complex_conjugate",
              "rotate_vector(3), NAF"]
ROTATIONS = ["apply_galois", "rotate_vector(1)"]
CASES = ([("first", op) for op in CHEAP + FIRST_ONLY + ROTATIONS]
         + [("switched", op) for op in CHEAP + ROTATIONS]
         + [("rescaled", op) for op in CHEAP])


def _method_case(env, level, op):
    a, b, pt = env["levels"][level]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAL_TPU_DEVICE_SAMPLING", "0")
        out = _run(env, level, op)
    return {"a": a, "b": b, "plain": pt, "galois_keys": env["gk"]}, {"out": out}


@pytest.mark.parametrize("level,op", CASES, ids=[f"{lv}-{op}" for lv, op in CASES])
def test_method_equals_jax(env, level, op, request):
    ANSWERS.check(request.node.name, *_method_case(env, level, op))


def test_rescale_to_is_rescale_to_next_down_the_chain(env):
    pev, pctx = env["ev"], env["ctx"]
    a, _, pt = env["levels"]["first"]
    prod = pev.multiply_plain(a, pt)
    nxt = pctx.first_context_data().next_context_data.parms_id
    for got, want in ((pev.rescale_to(prod, nxt), pev.rescale_to_next(prod)), (pev.rescale_to(a, a.parms_id), a)):
        assert torch.equal(got.data, want.data) and (got.parms_id, got.scale) == (want.parms_id, want.scale)


def test_levels_are_the_ones_named(env):
    pctx = env["ctx"]
    chain = [pctx.first_parms_id, pctx.first_context_data().next_context_data.parms_id]
    chain.append(pctx.get_context_data(chain[1]).next_context_data.parms_id)
    for level, pid in zip(("first", "switched", "rescaled"), chain[:2] + chain[1:2]):
        a, b, pt = env["levels"][level]
        assert a.parms_id == b.parms_id == pt.parms_id == pid
        assert a.data.is_contiguous()


def _public_key_case(env):
    """The JAX package encrypts at the first level and switches down."""
    ctx = env["ctx"]
    encryptor = (JaxEncryptor if env["side"] == "jax" else P.Encryptor)(ctx, public_key=env["pk"])
    pids = (ctx.first_context_data().next_context_data.parms_id, ctx.last_parms_id)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAL_TPU_DEVICE_SAMPLING", "0")
        outs = {f"level {i + 1}": encryptor.encrypt_zero(pid) for i, pid in enumerate(pids)}
    assert [o.parms_id for o in outs.values()] == list(pids)
    return {"public_key": env["pk"]}, outs


def test_public_key_encryption_below_the_first_level(env, request):
    ANSWERS.check(request.node.name, *_public_key_case(env))


# -- (e) rejections ------------------------------------------------------------

def _rejections(env):
    side, ev, gk, rk, ctx = env["side"], env["ev"], env["gk"], env["rk"], env["ctx"]
    a, b, pt = env["levels"]["first"]
    low, _, low_pt = env["levels"]["switched"]
    coeff = env["Plaintext"].from_coeffs([1, 2, 3])
    scaled = a.copy()
    scaled.scale = a.scale * 2
    huge = pt.copy()
    huge.scale = 2.0 ** 170
    short = type(gk)()
    short.parms_id = gk.parms_id
    short.keys = [None if k is None else {"c0": k["c0"][:1] if side == "port" else (k["c0"][0][:1], k["c0"][1][:1]),
                                          "c1": k["c1"]} for k in gk.keys]
    wrong_id = type(gk)()
    wrong_id.parms_id = ctx.first_parms_id
    wrong_id.keys = gk.keys
    seeded = a.copy()
    seeded.seed_info = object()
    n = N
    return {
        "add: parameter mismatch": (lambda: ev.add(a, low), "encrypted1 and encrypted2 parameter mismatch"),
        "add: scale mismatch": (lambda: ev.add(a, scaled), "scale mismatch"),
        "add: NTT form mismatch": (lambda: ev.add(a, ev.transform_from_ntt(b)), "NTT form mismatch"),
        "add_many: empty": (lambda: ev.add_many([]), "encrypteds cannot be empty"),
        "add_plain: coefficient plaintext": (lambda: ev.add_plain(a, coeff), "CKKS operands must be in NTT form"),
        "add_plain: parameter mismatch": (lambda: ev.add_plain(a, low_pt), "encrypted and plain parameter mismatch"),
        "sub_plain: scale mismatch": (lambda: ev.sub_plain(scaled, pt), "scale mismatch"),
        "multiply_plain: parameter mismatch": (lambda: ev.multiply_plain(a, low_pt),
                                               "encrypted and plain parameter mismatch"),
        "multiply_plain: scale out of bounds": (lambda: ev.multiply_plain(a, huge), "scale out of bounds"),
        "transform_to_ntt: already NTT": (lambda: ev.transform_to_ntt(a), "encrypted is already in NTT form"),
        "transform_from_ntt: not NTT": (lambda: ev.transform_from_ntt(ev.transform_from_ntt(a)),
                                        "encrypted is not in NTT form"),
        "transform_plain_to_ntt: already NTT": (lambda: ev.transform_plain_to_ntt(pt, a.parms_id),
                                                "plain is already in NTT form"),
        "mod_switch_to_next: end of chain": (lambda: ev.mod_switch_to_next(ev.mod_switch_to(a, ctx.last_parms_id)),
                                             "end of modulus switching chain reached"),
        "mod_switch_to: higher level": (lambda: ev.mod_switch_to(low, ctx.first_parms_id),
                                        "cannot switch to higher level modulus"),
        "mod_switch_plain_to: coefficient plaintext": (lambda: ev.mod_switch_plain_to(coeff, ctx.last_parms_id),
                                                       "plain is not in NTT form"),
        "mod_switch_plain_to: higher level": (lambda: ev.mod_switch_plain_to(low_pt, ctx.first_parms_id),
                                              "cannot switch to higher level modulus"),
        "rescale_to: higher level": (lambda: ev.rescale_to(low, ctx.first_parms_id),
                                     "cannot switch to higher level modulus"),
        "apply_galois: even element": (lambda: ev.apply_galois(a, 4, gk), "Galois element is not valid"),
        "apply_galois: element too large": (lambda: ev.apply_galois(a, 2 * n + 1, gk), "Galois element is not valid"),
        "apply_galois: size 3": (lambda: ev.apply_galois(ev.multiply(a, b), 3, gk), "encrypted size must be 2"),
        "apply_galois: key not present": (lambda: ev.apply_galois(a, 9, gk), "Galois key not present"),
        "apply_galois: keys of another level": (lambda: ev.apply_galois(a, 3, wrong_id),
                                                "galois_keys is not valid for encryption parameters"),
        "apply_galois: too few key rows": (lambda: ev.apply_galois(a, 3, short),
                                           "key-switching keys are invalid for encryption parameters"),
        "apply_galois: not NTT": (lambda: ev.apply_galois(ev.transform_from_ntt(a), 3, gk),
                                  "CKKS encrypted must be in NTT form"),
        "rotate_vector: no key, no NAF": (lambda: ev.rotate_vector(a, 2, gk), "Galois key not present"),
        "rotate_vector: step too large": (lambda: ev.rotate_vector(a, n // 2, gk), "step count too large"),
        "rotate_rows: CKKS": (lambda: ev.rotate_rows(a, 1, gk), "unsupported scheme"),
        "rotate_columns: CKKS": (lambda: ev.rotate_columns(a, gk), "unsupported scheme"),
        "relinearize: keys of another level": (lambda: ev.relinearize(ev.multiply(a, b), wrong_id),
                                               "relin_keys is not valid for encryption parameters"),
        "multiply_many: CKKS": (lambda: ev.multiply_many([a, b], rk), "unsupported scheme"),
        "seeded ciphertext": (lambda: ev.negate(seeded), "ciphertext is not valid for encryption parameters"),
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


def answers(side):
    """(case id, inputs, outputs) of every case that reads frozen answers."""
    env = _env(side)
    for level, op in CASES:
        yield (f"test_method_equals_jax[{level}-{op}]", *_method_case(env, level, op))
    yield ("test_public_key_encryption_below_the_first_level", *_public_key_case(env))
    yield ("test_rejections_equal_jax", *_rejection_case(env))


@pytest.mark.slow
def test_frozen_answers_equal_the_jax_package():
    JA.check_twin(__file__, answers("jax"), answers("port"))


def _scheme_context(scheme):
    parms = P.EncryptionParameters(scheme)
    parms.set_poly_modulus_degree(64)
    parms.set_coeff_modulus(P.CoeffModulus.create(64, [40, 40, 40]))
    parms.set_plain_modulus(P.Modulus(257))
    return P.SealContext(parms, True, P.SecurityLevel.NONE, device="cpu")


def test_bfv_contexts_raise_not_ported():
    """BFV and BGV on a 2-rank limb mesh (one limb each): the mesh-aware
    evaluator equals the evaluator without a mesh, method by method, on
    uniform residues and keys; rotate_vector on BGV raises "unsupported
    scheme"."""
    from seal_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(5)

    def residues(moduli, lead):
        return rng.integers(0, np.array(moduli, dtype=np.uint64)[:, None], (*lead, len(moduli), 64), dtype=np.uint64)

    for scheme, ntt in ((P.SchemeType.BFV, False), (P.SchemeType.BGV, True)):
        ctx = _scheme_context(scheme)
        qv, key_q = ctx.first_context_data().coeff_modulus_values, ctx.key_context_data().coeff_modulus_values
        key = lambda: tuple(residues(key_q, (len(qv),)) for _ in range(2))
        rk = C.relin_keys_from_numpy([key()], ctx.key_parms_id, "cpu")
        galois = [None] * 64
        galois[1] = key()                     # element 3: rotate_rows(1)
        gk = C.galois_keys_from_numpy(galois, ctx.key_parms_id, "cpu")
        ev = P.Evaluator(ctx)
        mev = P.Evaluator(ctx, mesh=make_mesh(2, limb_parallel=2, devices=["cpu"] * 2))
        ct = C.ciphertext_from_numpy(residues(qv, (2,)), ctx.first_parms_id, ntt, 1.0, "cpu", 3)
        sharded = mev.shard(ct)
        plain = P.Plaintext.from_coeffs([1, 2])
        calls = {
            "multiply": lambda e, c: e.multiply(c, c), "mod_switch_to_next": lambda e, c: e.mod_switch_to_next(c),
            "negate": lambda e, c: e.negate(c), "rotate_rows": lambda e, c: e.rotate_rows(c, 1, gk),
            "multiply_plain": lambda e, c: e.multiply_plain(c, plain),
            "multiply_many": lambda e, c: e.multiply_many([c, c], rk), "add_plain": lambda e, c: e.add_plain(c, plain),
        }
        for name, call in calls.items():
            got, want = call(mev, sharded), call(ev, ct)
            assert torch.equal(got.data.unshard(), want.data), (scheme.name, name)
            assert got.parms_id == want.parms_id and got.correction_factor == want.correction_factor
    with pytest.raises(ValueError, match="unsupported scheme"):
        mev.rotate_vector(sharded, 1, gk)


# -- (h) the surface ---------------------------------------------------------------

def test_evaluator_has_every_method_of_the_jax_package():
    jax_methods = {m for m in dir(JaxEvaluator) if not m.startswith("_") and callable(getattr(JaxEvaluator, m))}
    port_methods = {m for m in dir(P.Evaluator) if not m.startswith("_") and callable(getattr(P.Evaluator, m))}
    assert jax_methods <= port_methods, sorted(jax_methods - port_methods)
