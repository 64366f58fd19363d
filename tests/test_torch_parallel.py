"""The port's multi-device layer against the JAX package, on CPU meshes.

The JAX package runs on its 8 virtual CPU devices (``tests/conftest.py``),
the port on 8-rank meshes of ``["cpu"] * 8``.  Inputs are uniform residues
made with numpy from a seed and carried across as numpy uint64 arrays:

(a) ``BatchEvaluator`` multiply -> relinearize -> rescale_to_next at N=64,
    bits [40, 30, 30, 30, 40], B=8 (the shape of ``tests/test_parallel.py``):
    the port's batch, unsharded and on the (4, 2) and (2, 2, 2) meshes,
    equals the JAX package's batch, and each request equals the port's
    single-ciphertext evaluator;
(b) batched add, sub, negate and square against the JAX package's;
(c) ``Evaluator(mesh=...)`` against the evaluator without a mesh;
(d) the sharded contraction of ``tests/test_shard_ops.py``, as relinearize
    runs it, against the one-device contraction and exact integers;
(e) placement: meshes, the uneven limb split after a rescale, the
    collectives' layouts, and what raises;
(f) the batched Galois ops (apply_galois, rotate_vector with and without a
    NAF decomposition), multiply_plain on its four branches, add_plain,
    sub_plain, the NTT transforms and the limb drops, on a batch of 3: equal
    to the port's Evaluator on each ciphertext, to the JAX package's batch
    (the Galois ops, the NTT-form plaintext ops and the limb drop), and, on
    the (data 4, limb 2) mesh (one data rank empty), to the batch on one
    device.

The JAX package's answers to (a), (b) and (f) are frozen in
``tests/data/jax_answers/`` (``tests/jax_answers.py``); the test marked
``slow`` recomputes them.  Every comparison is exact equality.
"""

import numpy as np
import pytest
import torch

from seal_tpu.context import SealContext as JaxContext
from seal_tpu.data import GaloisKeys as JaxGaloisKeys, Plaintext as JaxPlaintext, RelinKeys as JaxRelinKeys
from seal_tpu.modulus import CoeffModulus as JaxCoeffModulus, SecurityLevel as JaxSecurityLevel
from seal_tpu.ops import u64 as JU
from seal_tpu.parallel import BatchEvaluator as JaxBatchEvaluator
from seal_tpu.parallel.batch import CiphertextBatch as JaxCiphertextBatch
from seal_tpu.params import EncryptionParameters as JaxParameters, SchemeType as JaxScheme

import seal_tpu_torch as P
from seal_tpu_torch.ckks_bodies import key_switch_contract
from seal_tpu_torch.convert import (ciphertext_from_numpy, galois_keys_from_numpy, plaintext_from_numpy,
                                    relin_keys_from_numpy, u64_from_numpy, u64_to_numpy)
from seal_tpu_torch.evaluator import Evaluator
from seal_tpu_torch.parallel import collectives as C
from seal_tpu_torch.parallel import sharded
from seal_tpu_torch.parallel.batch import BatchEvaluator, CiphertextBatch
from seal_tpu_torch.parallel.mesh import PartitionSpec, make_mesh, shard, shard_kswitch_key, split_bounds
from seal_tpu_torch.parallel.shard_ops import gather_add_mod

import jax_answers as JA

N, BITS, B, SCALE = 64, [40, 30, 30, 30, 40], 8, 2.0 ** 30
CPU8 = ["cpu"] * 8
MESHES = {
    "data4_limb2": dict(limb_parallel=2),
    "host2_data2_limb2_replicated_keys": dict(limb_parallel=2, hosts=2, replicate_keys=True),
}


def _residues(rng, moduli, lead):
    q = np.array(moduli, dtype=np.uint64).reshape(-1, 1)
    return rng.integers(0, q, (*lead, len(moduli), N), dtype=np.uint64)


ANSWERS = JA.Answers(__file__)
PIPELINE = ("multiply", "relinearize", "rescale_to_next")
ELEMENTWISE = ("add", "sub", "negate", "square")


def _jax_context():
    jp = JaxParameters(JaxScheme.CKKS)
    jp.set_poly_modulus_degree(N)
    jp.set_coeff_modulus(JaxCoeffModulus.create(N, BITS))
    return JaxContext(jp, True, JaxSecurityLevel.NONE)


def _port_context():
    pp = P.EncryptionParameters(P.SchemeType.CKKS)
    pp.set_poly_modulus_degree(N)
    pp.set_coeff_modulus(P.CoeffModulus.create(N, BITS))
    return P.SealContext(pp, True, P.SecurityLevel.NONE, device="cpu")


@pytest.fixture(scope="module")
def state():
    """The port's context and the numpy inputs."""
    return _state()


def _state():
    pctx = _port_context()
    rng = np.random.default_rng(2024)
    qv = pctx.first_context_data().coeff_modulus_values
    d1, d2 = _residues(rng, qv, (B, 2)), _residues(rng, qv, (B, 2))
    kc0, kc1 = (_residues(rng, pctx.key_context_data().coeff_modulus_values, (len(qv),)) for _ in range(2))
    rk = relin_keys_from_numpy([(kc0, kc1)], pctx.key_parms_id, "cpu")
    return {"ctx": pctx, "d1": d1, "d2": d2, "rk": rk, "kc": (kc0, kc1)}


def _state_inputs(s):
    return {"d1": s["d1"], "d2": s["d2"], "relin key c0": s["kc"][0], "relin key c1": s["kc"][1]}


def _jax_outputs(s):
    """The JAX package's batched pipeline and elementwise ops."""
    jctx = _jax_context()
    assert jctx.first_parms_id == s["ctx"].first_parms_id
    jrk = JaxRelinKeys()
    jrk.parms_id = jctx.key_parms_id
    jrk.keys = [{"c0": JU.from_np_u64(s["kc"][0]), "c1": JU.from_np_u64(s["kc"][1]), "seeds": None}]
    jbev = JaxBatchEvaluator(jctx)
    jb1, jb2 = (JaxCiphertextBatch(JU.from_np_u64(d), jctx.first_parms_id, True, SCALE, 1) for d in (s["d1"], s["d2"]))
    return dict(zip(PIPELINE, _pipeline(jbev, jb1, jb2, jrk)), **_elementwise(jbev, jb1, jb2))


def _elementwise(bev, b1, b2):
    return {"add": bev.add(b1, b2), "sub": bev.sub(b1, b2), "negate": bev.negate(b1), "square": bev.square(b1)}


def _batches(s):
    def batch(d):
        return CiphertextBatch(u64_from_numpy(d, "cpu"), s["ctx"].first_parms_id, True, SCALE)
    return batch(s["d1"]), batch(s["d2"])


def _pipeline(bev, b1, b2, rk):
    prod = bev.multiply(b1, b2)
    relin = bev.relinearize(prod, rk)
    return prod, relin, bev.rescale_to_next(relin)


def test_batched_pipeline_matches_jax_and_single_evaluator(state, request):
    b1, b2 = _batches(state)
    outs = _pipeline(BatchEvaluator(state["ctx"]), b1, b2, state["rk"])
    ANSWERS.check(request.node.name, _state_inputs(state), dict(zip(PIPELINE, outs)))
    out = outs[-1]
    ev = Evaluator(state["ctx"])
    for i in range(B):
        a = ciphertext_from_numpy(state["d1"][i], state["ctx"].first_parms_id, True, SCALE, "cpu")
        b = ciphertext_from_numpy(state["d2"][i], state["ctx"].first_parms_id, True, SCALE, "cpu")
        single = ev.rescale_to_next(ev.relinearize(ev.multiply(a, b), state["rk"]))
        assert torch.equal(out[i].data, single.data) and out[i].scale == single.scale


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_pipeline_matches_jax_and_unsharded(state, mesh, request):
    hem = make_mesh(8, devices=CPU8, **MESHES[mesh])
    bev = BatchEvaluator(state["ctx"], hem)
    b1, b2 = (bev.shard(b) for b in _batches(state))
    outs = _pipeline(bev, b1, b2, state["rk"])
    assert all(got.data.spec == hem.ct_batch_spec() for got in outs)
    ANSWERS.check(request.node.name, _state_inputs(state), dict(zip(PIPELINE, outs)))
    b1, b2 = _batches(state)
    want = _pipeline(BatchEvaluator(state["ctx"]), b1, b2, state["rk"])[-1]
    got = _pipeline(bev, bev.shard(b1), bev.shard(b2), state["rk"])[-1]
    assert torch.equal(got.unshard().data, want.data) and got.scale == want.scale


def test_rescale_splits_the_remaining_limbs_like_tensor_split(state):
    """After a rescale, 4 limbs over a limb axis of 2 (2 + 2) become 3,
    split 2 + 1."""
    hem = make_mesh(8, limb_parallel=2, devices=CPU8)
    bev = BatchEvaluator(state["ctx"], hem)
    b1, b2 = (bev.shard(b) for b in _batches(state))
    relin = bev.relinearize(bev.multiply(b1, b2), state["rk"])
    assert [s.shape[2] for s in relin.data.shards] == [2, 2] * 4
    out = bev.rescale_to_next(relin)
    whole = out.data.unshard()
    for r, local in enumerate(out.data.shards):
        limb = hem.mesh.coords(r)["limb"]
        data = hem.mesh.coords(r)["data"]
        assert local.shape[2] == (2, 1)[limb]
        want = torch.tensor_split(torch.tensor_split(whole, 4, dim=0)[data], 2, dim=2)[limb]
        assert torch.equal(local, want)


@pytest.mark.parametrize("mesh", [None, *MESHES])
def test_batched_add_sub_negate_square_match_jax(state, mesh, request):
    hem = None if mesh is None else make_mesh(8, devices=CPU8, **MESHES[mesh])
    bev = BatchEvaluator(state["ctx"], hem)
    b1, b2 = (bev.shard(b) for b in _batches(state))
    ANSWERS.check(request.node.name, _state_inputs(state), _elementwise(bev, b1, b2))


def test_evaluator_on_a_mesh_matches_the_evaluator_without(state):
    ctx = state["ctx"]
    hem = make_mesh(8, limb_parallel=2, devices=CPU8)
    ev, evm = Evaluator(ctx), Evaluator(ctx, mesh=hem)
    rk_sharded = evm.shard_keys(state["rk"])
    assert rk_sharded.key(2)["c0"].spec == hem.key_spec()
    for i in range(2):
        a = ciphertext_from_numpy(state["d1"][i], ctx.first_parms_id, True, SCALE, "cpu")
        b = ciphertext_from_numpy(state["d2"][i], ctx.first_parms_id, True, SCALE, "cpu")
        want = ev.rescale_to_next(ev.relinearize(ev.multiply(a, b), state["rk"]))
        sa, sb = evm.shard(a), evm.shard(b)
        assert sa.data.spec == hem.ct_spec()
        for keys in (rk_sharded, state["rk"]):    # sharded keys, and keys the evaluator shards itself
            got = evm.rescale_to_next(evm.relinearize(evm.multiply(sa, sb), keys))
            assert torch.equal(got.data.unshard(), want.data)
            assert got.scale == want.scale and got.parms_id == want.parms_id
    assert Evaluator(ctx).shard(a) is a       # no mesh: placement is a no-op


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_contraction_matches_exact_integers(state, mesh):
    """The contraction of ``tests/test_shard_ops.py`` as relinearize runs it:
    each limb rank contracts its own decomposition rows (kernel B's plain
    version, row offset) and the limb group gathers and adds the partial
    sums mod q.  Every rank's sum equals the one-device contraction of its
    requests, and the gather-add equals exact integer sums."""
    ctx = state["ctx"]
    cd = ctx.first_context_data()
    ev = Evaluator(ctx)
    plan = ev._plan(cd)
    hem = make_mesh(8, devices=CPU8, **MESHES[mesh])
    bev = BatchEvaluator(ctx, hem)
    prod = bev.multiply(*(bev.shard(b) for b in _batches(state))).data
    totals = sharded.contract(ev._plan, cd, prod, 2, shard_kswitch_key(hem, state["rk"].key(2)))
    kc0, kc1 = state["rk"].key(2)["c0"], state["rk"].key(2)["c1"]
    want = key_switch_contract(plan, prod.unshard()[:, 2], kc0[:plan.D], kc1[:plan.D], 0, plan.D)
    for r, total in enumerate(totals):        # (B / data ranks, 2, Rn, n) on every rank
        lo, hi = prod.block(r, 0)
        assert torch.equal(total, want[lo:hi])

    rng = np.random.default_rng(4)
    sel = [int(q) for q in u64_to_numpy(plan.sel_tables.q).ravel()]
    partials = [_residues(rng, sel, ()) for _ in range(hem.limb_size)]      # (R, n) each, below q
    exact = np.array([[sum(int(p[i, c]) for p in partials) % q for c in range(N)] for i, q in enumerate(sel)],
                     dtype=np.uint64)
    summed = gather_add_mod([u64_from_numpy(p, "cpu") for p in partials], [plan.sel_tables.q] * len(partials))
    for local in summed:                      # every rank of the group holds the whole sum
        np.testing.assert_array_equal(u64_to_numpy(local), exact)


def test_make_mesh_places_ranks_only_where_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="cards"):
        make_mesh(8, limb_parallel=2)
    with pytest.raises(ValueError):
        make_mesh(8, devices=["cpu"] * 4)
    with pytest.raises(ValueError):
        make_mesh(6, limb_parallel=4, devices=["cpu"] * 6)
    hem = make_mesh(8, limb_parallel=2, devices=CPU8)
    assert (hem.batch_size, hem.limb_size, hem.host_size) == (4, 2, 1)
    assert hem.mesh.shape == {"data": 4, "limb": 2}
    hem3 = make_mesh(8, limb_parallel=2, hosts=2, replicate_keys=True, devices=CPU8)
    assert hem3.mesh.shape == {"host": 2, "data": 2, "limb": 2}
    assert (hem3.batch_size, hem3.limb_size, hem3.host_size) == (4, 2, 2)
    assert hem3.ct_batch_spec() == PartitionSpec(("host", "data"), None, "limb", None)
    assert hem3.key_spec() == PartitionSpec() and hem.key_spec() == PartitionSpec("limb", None, None)
    assert all(d == torch.device("cpu") for d in hem.mesh.devices.ravel())


def test_shard_and_unshard_round_trip_uneven_splits():
    mesh = make_mesh(8, limb_parallel=2, hosts=2, devices=CPU8).mesh
    x = torch.arange(5 * 3 * 7 * 4).reshape(5, 3, 7, 4)
    st = shard(mesh, x, PartitionSpec(("host", "data"), None, "limb"))
    for r, local in enumerate(st.shards):
        c = mesh.coords(r)
        want = torch.tensor_split(torch.tensor_split(x, 4, dim=0)[2 * c["host"] + c["data"]], 2, dim=2)[c["limb"]]
        assert torch.equal(local, want)
    assert torch.equal(st.unshard(), x)
    assert split_bounds(3, 2) == [(0, 2), (2, 3)] and split_bounds(1, 2) == [(0, 1), (1, 1)]


def test_collectives_follow_lax_layouts():
    rng = np.random.default_rng(0)
    P_, k, r, c = 4, 2, 3, 5
    xs = [torch.from_numpy(rng.integers(0, 1 << 40, (k, P_, r, c))) for _ in range(P_)]
    out = C.all_to_all(xs, 1, 2)                          # lax.all_to_all(split 1, concat 2, tiled=False)
    for j in range(P_):
        assert out[j].shape == (k, r, P_, c)
        for m in range(P_):
            assert torch.equal(out[j][:, :, m], xs[m][:, j])
    gathered = C.all_gather(xs)
    assert all(torch.equal(g, torch.stack(xs)) for g in gathered)
    assert all(torch.equal(b, xs[2]) for b in C.broadcast(xs, 2))
    pieces = [torch.arange(0, 3), torch.arange(3, 4), torch.arange(4, 8)]
    ranges = [(0, 3), (3, 4), (4, 8)]
    assert torch.equal(C.gather_range(pieces, ranges, 2, 6, 0, "cpu"), torch.arange(2, 6))
    assert C.gather_range(pieces, ranges, 4, 7, 0, "cpu").data_ptr() == pieces[2][0:].data_ptr()
    with pytest.raises(ValueError):
        C.gather_range(pieces[:1], ranges[:1], 2, 6, 0, "cpu")


def _scheme_context(scheme):
    parms = P.EncryptionParameters(scheme)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(P.CoeffModulus.create(N, BITS))
    parms.set_plain_modulus(P.Modulus(257))
    return P.SealContext(parms, True, P.SecurityLevel.NONE, device="cpu")


def _uniform_keys(ctx, rng):
    """Relinearization keys and Galois keys for rotate_rows(1) and
    rotate_columns, of uniform residues."""
    qv, key_q = ctx.first_context_data().coeff_modulus_values, ctx.key_context_data().coeff_modulus_values
    key = lambda: tuple(_residues(rng, key_q, (len(qv),)) for _ in range(2))
    rk = relin_keys_from_numpy([key()], ctx.key_parms_id, "cpu")
    galois = [None] * N
    for elt in (3, 2 * N - 1):
        galois[elt >> 1] = key()
    return rk, galois_keys_from_numpy(galois, ctx.key_parms_id, "cpu")


def test_unported_batch_methods_name_their_roadmap_item(state):
    """BFV and BGV batches on a (data 4, limb 2) mesh equal the batch on one
    device, method by method; rotate_rows, rotate_columns and
    multiply_many on CKKS raise "unsupported scheme"."""
    bev = BatchEvaluator(state["ctx"])
    b1, _ = _batches(state)
    for call in (lambda: bev.rotate_rows(b1, 1, None), lambda: bev.rotate_columns(b1, None),
                 lambda: bev.multiply_many([b1, b1], state["rk"])):
        with pytest.raises(ValueError, match="unsupported scheme"):
            call()
    rng = np.random.default_rng(13)
    for scheme, ntt in ((P.SchemeType.BFV, False), (P.SchemeType.BGV, True)):
        ctx = _scheme_context(scheme)
        rk, gk = _uniform_keys(ctx, rng)
        data = u64_from_numpy(_residues(rng, ctx.first_context_data().coeff_modulus_values, (8, 2)), "cpu")
        batch = CiphertextBatch(data, ctx.first_parms_id, ntt, correction_factor=1 if scheme == P.SchemeType.BFV else 5)
        one = BatchEvaluator(ctx)
        mesh_bev = BatchEvaluator(ctx, make_mesh(8, limb_parallel=2, devices=CPU8))
        sharded_batch = mesh_bev.shard(batch)
        methods = [("multiply", (batch,)), ("mod_switch_to_next", ()), ("negate", ()),
                   ("multiply_plain", (P.Plaintext.from_coeffs([1, 2]),)), ("rotate_rows", (1, gk)),
                   ("rotate_columns", (gk,))]
        for method, args in methods:
            margs = tuple(sharded_batch if a is batch else a for a in args)
            got = getattr(mesh_bev, method)(sharded_batch, *margs)
            want = getattr(one, method)(batch, *args)
            assert torch.equal(got.unshard().data, want.data), (scheme.name, method)
            assert got.correction_factor == want.correction_factor and got.parms_id == want.parms_id
        got = mesh_bev.multiply_many([sharded_batch, sharded_batch], rk)
        assert torch.equal(got.unshard().data, one.multiply_many([batch, batch], rk).data), scheme.name


# -- (f) the batched Galois, plaintext and transform methods ---------------------

GB = 3
GALOIS_STEPS = {1: 3, -1: None, 4: None}          # step -> element; 3 rotates by NAF [-1, 4]
# the ops held to the JAX package's BatchEvaluator here; each compiles there
# once per level in seconds, so the NTT-heavy ones (the coefficient-form
# multiply_plain, the transforms) and the rotation one level down are held to
# the port's Evaluator, which tests/test_torch_evaluator.py holds to the JAX
# package's
JAX_BATCH_OPS = ("apply_galois", "rotate_vector(1)", "rotate_vector(3), NAF", "multiply_plain ntt x ntt",
                 "add_plain", "sub_plain", "mod_switch_to_next")


@pytest.fixture(scope="module")
def galois_state():
    """A batch of 3, a plaintext, a coefficient plaintext and Galois keys
    of uniform residues."""
    return _galois_state()


def _galois_state():
    pctx = _port_context()
    rng = np.random.default_rng(6)
    qv = pctx.first_context_data().coeff_modulus_values
    key_q = pctx.key_context_data().coeff_modulus_values
    data = _residues(rng, qv, (GB, 2))
    plain = _residues(rng, qv, ())
    coeffs = {"general": rng.integers(0, 1 << 20, N, dtype=np.uint64),
              "monomial": np.array([0] * 7 + [5], dtype=np.uint64)}
    tool = pctx.first_context_data().galois_tool
    elts = [tool.get_elt_from_step(s) for s in GALOIS_STEPS]
    keys = [None] * N
    for e in elts:
        keys[(e - 1) >> 1] = (_residues(rng, key_q, (len(qv),)), _residues(rng, key_q, (len(qv),)))
    pt = plaintext_from_numpy(plain, pctx.first_parms_id, SCALE, "cpu")
    return {"ctx": pctx, "data": data, "plain": plain, "pt": pt, "coeffs": coeffs, "keys": keys,
            "gk": galois_keys_from_numpy(keys, pctx.key_parms_id, "cpu")}


def _galois_inputs(s):
    return {"data": s["data"], "plain": s["plain"], "general": s["coeffs"]["general"],
            "monomial": s["coeffs"]["monomial"], "galois keys": s["gk"]}


def _jax_galois_outputs(s):
    """The JAX package's batch on the ops of JAX_BATCH_OPS."""
    jctx = _jax_context()
    jgk = JaxGaloisKeys()
    jgk.parms_id = jctx.key_parms_id
    jgk.keys = [None if k is None else {"c0": JU.from_np_u64(k[0]), "c1": JU.from_np_u64(k[1])} for k in s["keys"]]
    jpt = JaxPlaintext()
    jpt.parms_id, jpt.scale, jpt.rns_data = jctx.first_parms_id, SCALE, JU.from_np_u64(s["plain"])
    jb = JaxCiphertextBatch(JU.from_np_u64(s["data"]), jctx.first_parms_id, True, SCALE, 1)
    return {name: fn(jb) for name, fn in _galois_ops(JaxBatchEvaluator(jctx), jpt, JaxPlaintext, s["coeffs"], jgk)
            if name in JAX_BATCH_OPS}


def _galois_ops(ev, pt, plain_type, coeffs, gk):
    """(name, fn(batch or ciphertext)) for each method, through the methods
    the Evaluator and the BatchEvaluator share."""
    coeff = {name: plain_type.from_coeffs(v) for name, v in coeffs.items()}
    for p in coeff.values():
        p.scale = 2.0 ** 8
    return [
        ("apply_galois", lambda b: ev.apply_galois(b, 3, gk)),
        ("rotate_vector(1)", lambda b: ev.rotate_vector(b, 1, gk)),
        ("rotate_vector(3), NAF", lambda b: ev.rotate_vector(b, 3, gk)),
        ("multiply_plain ntt x ntt", lambda b: ev.multiply_plain(b, pt)),
        ("multiply_plain ntt x coeff", lambda b: ev.multiply_plain(b, coeff["general"])),
        ("multiply_plain coeff x ntt", lambda b: ev.multiply_plain(ev.transform_from_ntt(b), pt)),
        ("multiply_plain coeff x coeff, general", lambda b: ev.multiply_plain(ev.transform_from_ntt(b),
                                                                              coeff["general"])),
        ("multiply_plain coeff x coeff, monomial", lambda b: ev.multiply_plain(ev.transform_from_ntt(b),
                                                                               coeff["monomial"])),
        ("add_plain", lambda b: ev.add_plain(b, pt)),
        ("sub_plain", lambda b: ev.sub_plain(b, pt)),
        ("transform_to_ntt", lambda b: ev.transform_to_ntt(ev.transform_from_ntt(b))),
        ("mod_switch_to_next", lambda b: ev.mod_switch_to_next(b)),
        ("mod_reduce_to_next, rotated", lambda b: ev.rotate_vector(ev.mod_reduce_to_next(b), 1, gk)),
    ]


def _galois_batch(s):
    return CiphertextBatch(u64_from_numpy(s["data"], "cpu"), s["ctx"].first_parms_id, True, SCALE)


@pytest.mark.parametrize("op", range(13))
def test_batched_galois_and_plain_ops_match_jax_and_single_evaluator(galois_state, op, request):
    s = galois_state
    bev = BatchEvaluator(s["ctx"])
    name, fn = _galois_ops(bev, s["pt"], P.Plaintext, s["coeffs"], s["gk"])[op]
    got = fn(_galois_batch(s))
    if name in JAX_BATCH_OPS:
        ANSWERS.check(request.node.name, _galois_inputs(s), {name: got})
    _, single = _galois_ops(Evaluator(s["ctx"]), s["pt"], P.Plaintext, s["coeffs"], s["gk"])[op]
    for i in range(GB):
        a = ciphertext_from_numpy(s["data"][i], s["ctx"].first_parms_id, True, SCALE, "cpu")
        want = single(a)
        assert torch.equal(got[i].data, want.data) and (got.scale, got.parms_id) == (want.scale, want.parms_id)


@pytest.mark.parametrize("op", range(13))
def test_batched_galois_and_plain_ops_on_a_mesh_match_one_device(galois_state, op):
    s = galois_state
    hem = make_mesh(8, devices=CPU8, limb_parallel=2)
    bev, one = BatchEvaluator(s["ctx"], hem), BatchEvaluator(s["ctx"])
    name, fn = _galois_ops(bev, s["pt"], P.Plaintext, s["coeffs"], s["gk"])[op]
    got = fn(bev.shard(_galois_batch(s)))
    assert got.data.spec == hem.ct_batch_spec()
    want = _galois_ops(one, s["pt"], P.Plaintext, s["coeffs"], s["gk"])[op][1](_galois_batch(s))
    assert torch.equal(got.unshard().data, want.data), name
    assert (got.scale, got.parms_id, got.is_ntt_form) == (want.scale, want.parms_id, want.is_ntt_form)


def answers(side):
    """(case id, inputs, outputs) of every case that reads frozen answers;
    the port's side is its BatchEvaluator on one device."""
    s = _state()
    if side == "jax":
        outs = _jax_outputs(s)
    else:
        bev = BatchEvaluator(s["ctx"])
        b1, b2 = _batches(s)
        outs = dict(zip(PIPELINE, _pipeline(bev, b1, b2, s["rk"])), **_elementwise(bev, b1, b2))
    pipe, elem, inputs = {k: outs[k] for k in PIPELINE}, {k: outs[k] for k in ELEMENTWISE}, _state_inputs(s)
    yield "test_batched_pipeline_matches_jax_and_single_evaluator", inputs, pipe
    for mesh in MESHES:
        yield f"test_sharded_pipeline_matches_jax_and_unsharded[{mesh}]", inputs, pipe
    for mesh in (None, *MESHES):
        yield f"test_batched_add_sub_negate_square_match_jax[{mesh}]", inputs, elem
    g = _galois_state()
    if side == "jax":
        gouts = _jax_galois_outputs(g)
    else:
        ops = _galois_ops(BatchEvaluator(g["ctx"]), g["pt"], P.Plaintext, g["coeffs"], g["gk"])
        gouts = {name: fn(_galois_batch(g)) for name, fn in ops if name in JAX_BATCH_OPS}
    for op, (name, _) in enumerate(_galois_ops(None, None, P.Plaintext, g["coeffs"], None)):
        if name in JAX_BATCH_OPS:
            yield (f"test_batched_galois_and_plain_ops_match_jax_and_single_evaluator[{op}]", _galois_inputs(g),
                   {name: gouts[name]})


@pytest.mark.slow
def test_frozen_answers_equal_the_jax_package():
    JA.check_twin(__file__, answers("jax"), answers("port"))
