"""BFV and BGV on a mesh: the port's mesh bodies against the JAX package's
sharded batch and the port's single device, on CPU meshes.

The JAX package runs on its 8 virtual CPU devices (``tests/conftest.py``),
the port on 8-rank meshes of ``["cpu"] * 8``.  Inputs are uniform residues
made with numpy from a seed (ciphertexts, keys, NTT-form plaintexts) and
coefficient plaintexts below t, carried across as numpy uint64 arrays:

(a) N=64, bits [40, 30, 30, 30, 40], t = PlainModulus.batching(64, 20)
    (the setup of ``tests/test_batch_surface.py``), a batch of 8: every
    BFV and BGV method of the ``BatchEvaluator`` on the (data 4, limb 2)
    mesh and on the (host 2, data 2, limb 2) mesh with replicated keys
    equals the batch on one device; on the (data 4, limb 2) mesh it also
    equals the JAX package's ``BatchEvaluator`` on its
    ``make_mesh(8, limb_parallel=2)``, whose answers are frozen in
    ``tests/data/jax_answers/`` (``tests/jax_answers.py``; the test marked
    ``slow`` recomputes them);
(b) ``Evaluator(mesh=...)``: the methods the batch evaluator lacks
    (add_many, mod_switch_to, exponentiate) and a chain at N=1024 with k=5
    data limbs, split 3/2 over the limb axis, against the evaluator
    without a mesh;
(c) each limb-range function of ``ops/rns.py`` at N=1024, k=5, at the
    carry edges (every residue 0, every residue q_i - 1, and uniform),
    against the whole-limb function: the partial conversions added mod p,
    the Shenoy-Kumaresan conversion's own rows, BFV's modulus switch on a
    rank's limbs;
(d) ``dryrun.dryrun_multichip(8, devices=["cpu"] * 8)``.

Every comparison is exact equality.
"""

import contextlib

import numpy as np
import pytest
import torch

from seal_tpu.context import SealContext as JaxContext
from seal_tpu.data import GaloisKeys as JaxGaloisKeys, Plaintext as JaxPlaintext, RelinKeys as JaxRelinKeys
from seal_tpu.modulus import (CoeffModulus as JaxCoeffModulus, PlainModulus as JaxPlainModulus,
                              SecurityLevel as JaxSecurityLevel)
from seal_tpu.ops import u64 as JU
from seal_tpu.parallel import BatchEvaluator as JaxBatchEvaluator, make_mesh as jax_make_mesh
from seal_tpu.parallel.batch import CiphertextBatch as JaxCiphertextBatch
from seal_tpu.params import EncryptionParameters as JaxParameters, SchemeType as JaxScheme

import seal_tpu_torch as P
from seal_tpu_torch import dryrun
from seal_tpu_torch.convert import (ciphertext_from_numpy, galois_keys_from_numpy, plaintext_from_numpy,
                                    relin_keys_from_numpy, u64_from_numpy)
from seal_tpu_torch.ops import rns as R
from seal_tpu_torch.parallel.batch import BatchEvaluator, CiphertextBatch
from seal_tpu_torch.parallel.mesh import make_mesh, split_bounds
from seal_tpu_torch.parallel.shard_ops import gather_add_mod

import jax_answers as JA

N, BITS, B = 64, [40, 30, 30, 30, 40], 8
CPU8 = ["cpu"] * 8
MESHES = {
    "data4_limb2": dict(limb_parallel=2),
    "host2_data2_limb2_replicated_keys": dict(limb_parallel=2, hosts=2, replicate_keys=True),
}
# correction factors of the two BGV operands: add and sub balance them
FACTORS = {"BFV": (1, 1), "BGV": (1, 7)}
METHODS = ("multiply", "square", "relinearize", "apply_galois", "rotate_rows", "rotate_columns",
           "mod_switch_to_next", "mod_reduce_to_next", "add", "sub", "negate", "add_plain", "sub_plain",
           "multiply_plain, coefficient plain", "multiply_plain, monomial", "multiply_plain, NTT plain",
           "transform", "multiply_many")
ANSWERS = JA.Answers(__file__)


def _residues(rng, moduli, lead, n=N):
    q = np.array(moduli, dtype=np.uint64).reshape(-1, 1)
    return rng.integers(0, q, (*lead, len(moduli), n), dtype=np.uint64)


def _ops(ev, plains, gk, rk, other):
    """(name, fn(batch)) of each method, through the names the two packages'
    batch evaluators share; ``plains`` holds a coefficient plaintext, a
    monomial and an NTT-form plaintext of the package."""
    ntt_form = other.is_ntt_form
    return {
        "multiply": lambda b: ev.multiply(b, other),
        "square": lambda b: ev.square(b),
        "relinearize": lambda b: ev.relinearize(ev.multiply(b, other), rk),
        "apply_galois": lambda b: ev.apply_galois(b, 3, gk),
        "rotate_rows": lambda b: ev.rotate_rows(b, 1, gk),
        "rotate_columns": lambda b: ev.rotate_columns(b, gk),
        "mod_switch_to_next": lambda b: ev.mod_switch_to_next(b),
        "mod_reduce_to_next": lambda b: ev.mod_reduce_to_next(b),
        "add": lambda b: ev.add(b, other),
        "sub": lambda b: ev.sub(b, other),
        "negate": lambda b: ev.negate(b),
        "add_plain": lambda b: ev.add_plain(b, plains["coeff"]),
        "sub_plain": lambda b: ev.sub_plain(b, plains["coeff"]),
        "multiply_plain, coefficient plain": lambda b: ev.multiply_plain(b, plains["coeff"]),
        "multiply_plain, monomial": lambda b: ev.multiply_plain(b, plains["monomial"]),
        # BFV: coefficient batch x NTT plain, transformed there and back;
        # BGV: NTT x NTT
        "multiply_plain, NTT plain": lambda b: ev.multiply_plain(b, plains["ntt"]),
        "transform": lambda b: ev.transform_from_ntt(b) if ntt_form else ev.transform_to_ntt(b),
        "multiply_many": lambda b: ev.multiply_many([b, other, b], rk),
    }


def _scheme_inputs(scheme: str):
    rng = np.random.default_rng({"BFV": 11, "BGV": 12}[scheme])
    pp = P.EncryptionParameters(getattr(P.SchemeType, scheme))
    pp.set_poly_modulus_degree(N)
    pp.set_coeff_modulus(P.CoeffModulus.create(N, BITS))
    pp.set_plain_modulus(P.PlainModulus.batching(N, 20))
    ctx = P.SealContext(pp, True, P.SecurityLevel.NONE, device="cpu")
    qv, key_q = ctx.first_context_data().coeff_modulus_values, ctx.key_context_data().coeff_modulus_values
    t = pp.plain_modulus.value
    key = lambda: tuple(_residues(rng, key_q, (len(qv),)) for _ in range(2))
    galois = [None] * N
    for elt in (3, 2 * N - 1):
        galois[elt >> 1] = key()
    return {"ctx": ctx, "ntt": scheme == "BGV", "data": (_residues(rng, qv, (B, 2)), _residues(rng, qv, (B, 2))),
            "relin": [key()], "galois": galois, "coeff": rng.integers(0, t, N, dtype=np.uint64),
            "monomial": np.array([0] * 5 + [t - 3], dtype=np.uint64), "ntt_plain": _residues(rng, qv, ())}


@pytest.fixture(scope="module")
def inputs():
    return {scheme: _scheme_inputs(scheme) for scheme in ("BFV", "BGV")}


def _port_ops(s, bev, shard=lambda b: b):
    ctx = s["ctx"]
    f1, f2 = FACTORS["BGV" if s["ntt"] else "BFV"]
    b1, b2 = (shard(CiphertextBatch(u64_from_numpy(d, "cpu"), ctx.first_parms_id, s["ntt"], correction_factor=f))
              for d, f in zip(s["data"], (f1, f2)))
    plains = {"coeff": P.Plaintext.from_coeffs(s["coeff"]), "monomial": P.Plaintext.from_coeffs(s["monomial"]),
              "ntt": plaintext_from_numpy(s["ntt_plain"], ctx.first_parms_id, 1.0, "cpu")}
    rk = relin_keys_from_numpy(s["relin"], ctx.key_parms_id, "cpu")
    gk = galois_keys_from_numpy(s["galois"], ctx.key_parms_id, "cpu")
    return b1, _ops(bev, plains, gk, rk, b2), _inputs(b1, b2, rk, gk, plains)


def _inputs(b1, b2, rk, gk, plains):
    return {"batch": b1, "other": b2, "relin keys": rk, "galois keys": gk,
            **{f"{name} plain": p for name, p in plains.items()}}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("scheme", ["BFV", "BGV"])
def test_batch_on_a_mesh_equals_one_device(inputs, scheme, method, mesh):
    s = inputs[scheme]
    one_batch, one_ops, _ = _port_ops(s, BatchEvaluator(s["ctx"]))
    bev = BatchEvaluator(s["ctx"], make_mesh(8, devices=CPU8, **MESHES[mesh]))
    batch, ops, _ = _port_ops(s, bev, bev.shard)
    got, want = ops[method](batch), one_ops[method](one_batch)
    assert torch.equal(got.unshard().data, want.data)
    assert (got.parms_id, got.is_ntt_form, got.correction_factor) == (want.parms_id, want.is_ntt_form,
                                                                      want.correction_factor)


def _jax_ops(s, scheme):
    """The JAX package's sharded batch evaluator on its (data 4, limb 2)
    mesh, its batch, its ops and their inputs."""
    hem = jax_make_mesh(8, limb_parallel=2)
    jp = JaxParameters(getattr(JaxScheme, scheme))
    jp.set_poly_modulus_degree(N)
    jp.set_coeff_modulus(JaxCoeffModulus.create(N, BITS))
    jp.set_plain_modulus(JaxPlainModulus.batching(N, 20))
    jctx = JaxContext(jp, True, JaxSecurityLevel.NONE)
    assert jctx.first_parms_id == s["ctx"].first_parms_id
    jbev = JaxBatchEvaluator(jctx, hem)
    f1, f2 = FACTORS[scheme]
    b1, b2 = (jbev.shard(JaxCiphertextBatch(JU.from_np_u64(d), jctx.first_parms_id, s["ntt"], 1.0, f))
              for d, f in zip(s["data"], (f1, f2)))
    rk = JaxRelinKeys()
    rk.parms_id = jctx.key_parms_id
    rk.keys = [{"c0": JU.from_np_u64(c0), "c1": JU.from_np_u64(c1), "seeds": None} for c0, c1 in s["relin"]]
    gk = JaxGaloisKeys()
    gk.parms_id = jctx.key_parms_id
    gk.keys = [None if k is None else {"c0": JU.from_np_u64(k[0]), "c1": JU.from_np_u64(k[1])} for k in s["galois"]]
    ntt_plain = JaxPlaintext()
    ntt_plain.parms_id, ntt_plain.rns_data = jctx.first_parms_id, JU.from_np_u64(s["ntt_plain"])
    plains = {"coeff": JaxPlaintext.from_coeffs(s["coeff"]), "monomial": JaxPlaintext.from_coeffs(s["monomial"]),
              "ntt": ntt_plain}
    return hem, b1, _ops(jbev, plains, gk, rk, b2), _inputs(b1, b2, rk, gk, plains)


JAX_CASES = [(m, s) for s in ("BFV", "BGV") for m in METHODS]


@pytest.mark.parametrize("method, scheme", JAX_CASES)
def test_batch_on_a_mesh_equals_the_jax_package_on_its_mesh(inputs, scheme, method, request):
    s = inputs[scheme]
    bev = BatchEvaluator(s["ctx"], make_mesh(8, devices=CPU8, limb_parallel=2))
    batch, ops, ins = _port_ops(s, bev, bev.shard)
    ANSWERS.check(request.node.name, ins, {"out": ops[method](batch)})


def answers(side):
    """(case id, inputs, outputs) of every case that reads frozen answers."""
    for scheme in ("BFV", "BGV"):
        s = _scheme_inputs(scheme)
        if side == "jax":
            hem, batch, ops, ins = _jax_ops(s, scheme)
            context = hem.mesh
        else:
            bev = BatchEvaluator(s["ctx"], make_mesh(8, devices=CPU8, limb_parallel=2))
            (batch, ops, ins), context = _port_ops(s, bev, bev.shard), contextlib.nullcontext()
        for method in METHODS:
            with context:
                out = ops[method](batch)
            yield f"test_batch_on_a_mesh_equals_the_jax_package_on_its_mesh[{method}-{scheme}]", ins, {"out": out}


@pytest.mark.slow
def test_frozen_answers_equal_the_jax_package():
    JA.check_twin(__file__, answers("jax"), answers("port"))


# -- (b) Evaluator(mesh=...) -------------------------------------------------------

def _evaluator_pair(scheme: str, n: int, bits, limb: int = 2):
    pp = P.EncryptionParameters(getattr(P.SchemeType, scheme))
    pp.set_poly_modulus_degree(n)
    pp.set_coeff_modulus(P.CoeffModulus.create(n, bits))
    pp.set_plain_modulus(P.PlainModulus.batching(n, 20))
    ctx = P.SealContext(pp, True, P.SecurityLevel.NONE, device="cpu")
    return ctx, P.Evaluator(ctx), P.Evaluator(ctx, mesh=make_mesh(limb, limb_parallel=limb, devices=["cpu"] * limb))


@pytest.mark.parametrize("scheme", ["BFV", "BGV"])
def test_evaluator_on_a_mesh_add_many_mod_switch_to_exponentiate(inputs, scheme):
    s = inputs[scheme]
    ctx = s["ctx"]
    ev, mev = P.Evaluator(ctx), P.Evaluator(ctx, mesh=make_mesh(8, limb_parallel=2, devices=CPU8))
    rk = relin_keys_from_numpy(s["relin"], ctx.key_parms_id, "cpu")
    f1, f2 = FACTORS[scheme]
    cts = [ciphertext_from_numpy(s["data"][j][i], ctx.first_parms_id, s["ntt"], 1.0, "cpu", (f1, f2)[j])
           for i in range(2) for j in range(2)]
    sharded = [mev.shard(c) for c in cts]
    last = ctx.last_parms_id
    for name, call in (("add_many", lambda e, c: e.add_many(c)),
                       ("mod_switch_to", lambda e, c: e.mod_switch_to(c[0], last)),
                       ("exponentiate", lambda e, c: e.exponentiate(c[1], 3, rk)),
                       ("mod_switch_to_next of a square", lambda e, c: e.mod_switch_to_next(e.square(c[2])))):
        got, want = call(mev, sharded), call(ev, cts)
        assert torch.equal(got.data.unshard(), want.data), name
        assert (got.parms_id, got.correction_factor) == (want.parms_id, want.correction_factor), name


@pytest.mark.parametrize("scheme", ["BFV", "BGV"])
def test_evaluator_chain_at_n1024_splits_three_and_two(scheme):
    """k=5 data limbs over a limb axis of 2: limbs 3 + 2, then 2 + 2, 2 + 1
    and 1 + 1 after each modulus switch; real keys and encryptions."""
    ctx, ev, mev = _evaluator_pair(scheme, 1024, [40] * 6)
    assert len(ctx.first_context_data().coeff_modulus_values) == 5
    kg = P.KeyGenerator(ctx)
    rk, gk = kg.create_relin_keys(), kg.create_galois_keys_from_steps([1])
    enc, be = P.Encryptor(ctx, public_key=kg.create_public_key()), P.BatchEncoder(ctx)
    t = ctx.first_context_data().parms.plain_modulus.value
    rng = np.random.default_rng(3)
    a, b = (enc.encrypt(be.encode(rng.integers(0, t, 1024, dtype=np.uint64))) for _ in range(2))
    # BGV: b two levels down carries another correction factor than the chain
    a_, b_ = (a, b) if scheme == "BFV" else (a, ev.mod_switch_to_next(ev.mod_switch_to_next(b)))

    def chain(e, x, y):
        z = e.relinearize(e.multiply(x, x), rk)
        z = e.rotate_rows(e.mod_switch_to_next(z), 1, gk)
        z = e.mod_switch_to_next(z)
        return e.sub(z, e.mod_switch_to(y, z.parms_id))

    got, want = chain(mev, mev.shard(a_), mev.shard(b_)), chain(ev, a_, b_)
    assert torch.equal(got.data.unshard(), want.data)
    assert (got.parms_id, got.correction_factor) == (want.parms_id, want.correction_factor)
    assert [sh.shape[-2] for sh in got.data.shards] == [b - a for a, b in split_bounds(3, 2)]


# -- (c) the limb-range functions at the carry edges ----------------------------------

EDGES = ("zeros", "q minus one", "uniform")


def _edge_input(edge, moduli, lead, rng, n=1024):
    q = np.array(moduli, dtype=np.uint64).reshape(-1, 1)
    if edge == "zeros":
        return np.zeros((*lead, len(moduli), n), dtype=np.uint64)
    if edge == "q minus one":
        return np.broadcast_to(q - np.uint64(1), (*lead, len(moduli), n)).copy()
    return rng.integers(0, q, (*lead, len(moduli), n), dtype=np.uint64)


@pytest.fixture(scope="module")
def tool():
    pp = P.EncryptionParameters(P.SchemeType.BFV)
    pp.set_poly_modulus_degree(1024)
    pp.set_coeff_modulus(P.CoeffModulus.create(1024, [60, 60, 60, 60, 60, 60]))
    pp.set_plain_modulus(P.PlainModulus.batching(1024, 20))
    return P.SealContext(pp, True, P.SecurityLevel.NONE, device="cpu").first_context_data().rns_tool


@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("converter", ["conv_q_to_Bsk_m_tilde_scaled", "conv_q_to_Bsk"])
def test_partial_conversions_add_up_to_the_whole(tool, converter, edge):
    conv = getattr(tool, converter)
    x = u64_from_numpy(_edge_input(edge, conv.ibase.values, (2,), np.random.default_rng(1)), "cpu")
    parts = [R.fast_convert_array(x[..., lo:hi, :], conv, lo) for lo, hi in split_bounds(5, 2)]
    moduli = R.convert_moduli(conv, "cpu")
    for total in gather_add_mod(parts, [moduli] * 2):
        assert torch.equal(total, R.fast_convert_array(x, conv))
    empty = R.fast_convert_array(x[..., 5:, :], conv, 5)
    assert empty.shape == (2, conv.obase.size, 1024) and not empty.any()


@pytest.mark.parametrize("edge", EDGES)
def test_behz_steps_on_limb_ranges_equal_the_whole(tool, edge):
    rng = np.random.default_rng(2)
    x_q = u64_from_numpy(_edge_input(edge, tool.base_q.values, (3,), rng), "cpu")
    x_bsk = u64_from_numpy(_edge_input(edge, tool.base_Bsk.values, (3,), rng), "cpu")
    ranges = split_bounds(5, 2)
    ext = gather_add_mod([R.fastbconv_m_tilde(x_q[..., a:b, :], tool, a) for a, b in ranges],
                         [R.convert_moduli(tool.conv_q_to_Bsk_m_tilde_scaled, "cpu")] * 2)[0]
    assert torch.equal(ext, R.fastbconv_m_tilde(x_q, tool))
    dest = gather_add_mod([R.fast_convert_array(x_q[..., a:b, :], tool.conv_q_to_Bsk, a) for a, b in ranges],
                          [R.convert_moduli(tool.conv_q_to_Bsk, "cpu")] * 2)[0]
    floor = R.fast_floor_finish(x_bsk, dest, tool)
    assert torch.equal(floor, R.fast_floor(torch.cat([x_q, x_bsk], dim=-2), tool))
    for lo, hi in ranges + [(0, 5), (4, 5), (2, 2)]:
        assert torch.equal(R.fastbconv_sk(floor, tool, lo, hi), R.fastbconv_sk(floor, tool)[..., lo:hi, :])


@pytest.mark.parametrize("edge", EDGES)
def test_bfv_modulus_switch_on_limb_ranges_equals_the_whole(tool, edge):
    x = u64_from_numpy(_edge_input(edge, tool.base_q.values, (2,), np.random.default_rng(4)), "cpu")
    whole = R.divide_and_round_q_last(x, tool)
    for lo, hi in split_bounds(4, 2) + [(0, 4), (3, 4)]:
        got = R.divide_and_round_q_last_limbs(x[..., lo:hi, :], x[..., 4:, :], lo, tool)
        assert torch.equal(got, whole[..., lo:hi, :])


# -- (d) the dryrun -------------------------------------------------------------------

def test_dryrun_multichip_on_eight_cpu_ranks():
    dryrun.dryrun_multichip(8, devices=CPU8)
