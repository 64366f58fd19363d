"""BFV's host precompute of the PyTorch port against the JAX package.

(a) ``PlainModulus.batching`` / ``batching_many``;
(b) the BEHZ part of ``HostRNSTool``: the bases B, Bsk, Bsk U {m_tilde} and
    {t, gamma}, m_sk, gamma, the converters' change matrices and
    (prescaled) inverse punctured products, and every constant, for
    ``bfv_default(8192)`` with ``t = PlainModulus.batching(8192, 20)``, a
    small chain, and a chain whose B grows to k + 1 primes;
(c) ``HostRNSBase`` extend, drop, compose, decompose_array, compose_array;
(d) a BFV context's constants (Delta, q mod t, the lift, ``using_batching``)
    and its q U Bsk table bundle, whose t-scaled inverse equals the JAX
    package's ``tscaled_limb_tables`` of q and of Bsk;
(e) the BatchEncoder: encode, decode and their int64 variants, and the host
    C NTT's tables.

Exact equality throughout: all of it is integer arithmetic.
"""

import jax
import numpy as np
import pytest

from seal_tpu.context import SealContext as JaxContext
from seal_tpu.encoders import BatchEncoder as JaxBatchEncoder
from seal_tpu.modulus import (CoeffModulus as JaxCoeffModulus, Modulus as JaxModulus,
                              PlainModulus as JaxPlainModulus, SecurityLevel as JaxSecurityLevel)
from seal_tpu.ntt_tables import host_c_ntt_tables as jax_host_c_ntt_tables
from seal_tpu.ops import ntt as JNTT
from seal_tpu.ops import u64 as JU
from seal_tpu.params import EncryptionParameters as JaxParameters, SchemeType as JaxScheme
from seal_tpu.rns_host import HostRNSBase as JaxBase, HostRNSTool as JaxTool

import seal_tpu_torch as P
from seal_tpu_torch.convert import u64_from_numpy, u64_to_numpy
from seal_tpu_torch.encoders import BatchEncoder
from seal_tpu_torch.modulus import PlainModulus
from seal_tpu_torch.ntt_tables import host_c_ntt_tables
from seal_tpu_torch.ops import ntt as NTT
from seal_tpu_torch.rns_host import HostRNSBase, HostRNSTool

# (n, coefficient moduli, plain modulus): the default 128-bit chain at
# N=8192; a small chain; a one-prime chain with a 30-bit t, where
# 32 + 30 + 60 >= 60 (k + 1) grows B to k + 1 = 2 primes
CHAINS = {
    "bfv_default(8192)": (8192, lambda: [m.value for m in JaxCoeffModulus.bfv_default(8192)],
                          lambda: JaxPlainModulus.batching(8192, 20).value),
    "small": (1024, lambda: [m.value for m in JaxCoeffModulus.create(1024, [30, 30, 30])],
              lambda: JaxPlainModulus.batching(1024, 16).value),
    "B grows": (1024, lambda: [m.value for m in JaxCoeffModulus.create(1024, [60])],
                lambda: JaxPlainModulus.batching(1024, 30).value),
}


def _tools(name):
    n, moduli, t = CHAINS[name]
    qs, tv = moduli(), t()
    return (JaxTool(n, JaxBase([JaxModulus(q) for q in qs]), JaxModulus(tv)),
            HostRNSTool(n, HostRNSBase([P.Modulus(q) for q in qs]), P.Modulus(tv)))


def test_plain_modulus_factories_equal():
    for n, bits in ((8192, 20), (32768, 20), (1024, 16), (4096, 30)):
        assert PlainModulus.batching(n, bits).value == JaxPlainModulus.batching(n, bits).value
    assert [m.value for m in PlainModulus.batching_many(2048, [20, 20, 30])] == [
        m.value for m in JaxPlainModulus.batching_many(2048, [20, 20, 30])]
    assert PlainModulus.batching(8192, 20).value == 1032193
    assert PlainModulus.batching(32768, 20).value == 786433


CONVERTERS = ("conv_q_to_Bsk", "conv_q_to_Bsk_m_tilde_scaled", "conv_B_to_q_m_sk", "conv_q_to_t_gamma")
CONSTANTS = ("prod_B_mod_q", "inv_prod_q_mod_Bsk", "inv_prod_B_mod_m_sk", "inv_m_tilde_mod_Bsk",
             "neg_inv_prod_q_mod_m_tilde", "prod_q_mod_Bsk", "inv_gamma_mod_t", "prod_t_gamma_mod_q",
             "neg_inv_q_mod_t_gamma", "inv_q_last_mod_q", "inv_q_last_mod_t", "q_last_mod_t")


@pytest.mark.parametrize("name", list(CHAINS))
def test_behz_bases_and_constants_equal(name):
    jt, pt = _tools(name)
    for base in ("base_q", "base_B", "base_Bsk", "base_Bsk_m_tilde", "base_t_gamma"):
        jb, pb = getattr(jt, base), getattr(pt, base)
        assert pb.values == jb.values, base
        assert (pb.punctured_prod, pb.inv_punctured, pb.base_prod) == (
            jb.punctured_prod, jb.inv_punctured, jb.base_prod), base
    for m in ("m_sk", "gamma", "m_tilde"):
        assert getattr(pt, m).value == getattr(jt, m).value, m
    assert all(p.bit_length() == 60 for p in pt.base_Bsk.values)
    assert pt.m_tilde.value == 1 << 32
    for name_ in CONSTANTS:
        assert getattr(pt, name_) == getattr(jt, name_), name_
    k = pt.base_q.size
    assert pt.base_B.size == (k + 1 if name == "B grows" else k)


@pytest.mark.parametrize("name", list(CHAINS))
def test_converters_equal(name):
    jt, pt = _tools(name)
    for conv in CONVERTERS:
        jc, pc = getattr(jt, conv), getattr(pt, conv)
        assert pc.ibase.values == jc.ibase.values and pc.obase.values == jc.obase.values, conv
        assert pc.matrix == jc.matrix, conv
        assert pc.prescale == jc.prescale, conv
        # the reference folds the prescale into its Shoup operand
        dev = jc.device()
        want = JU.to_np_u64(dev["inv_punct_op"]).ravel().tolist()
        assert pc.inv_punct == want, conv


def test_rns_base_helpers_equal():
    qs = [m.value for m in JaxCoeffModulus.create(1024, [40, 50, 60])]
    jb, pb = JaxBase([JaxModulus(q) for q in qs]), HostRNSBase([P.Modulus(q) for q in qs])
    extra = JaxCoeffModulus.create(1024, [30])[0].value
    assert pb.extend(P.Modulus(extra)).values == jb.extend(JaxModulus(extra)).values
    assert pb.drop().values == jb.drop().values
    rng = np.random.default_rng(7)
    values = [int(v) * 12345678901234567 % pb.base_prod for v in rng.integers(0, 1 << 62, size=64)]
    values += [0, pb.base_prod - 1, pb.base_prod // 2]
    arr = np.array(values, dtype=object)
    np.testing.assert_array_equal(pb.decompose_array(arr), jb.decompose_array(arr))
    residues = pb.decompose_array(arr)
    assert pb.compose_array(residues) == jb.compose_array(residues) == values
    assert pb.compose(pb.decompose(values[0])) == jb.compose(jb.decompose(values[0])) == values[0]
    with pytest.raises(ValueError, match="cannot drop from base of size 1"):
        HostRNSBase([P.Modulus(qs[0])]).drop()


def _contexts(n, bits, t):
    jp = JaxParameters(JaxScheme.BFV)
    jp.set_poly_modulus_degree(n)
    jp.set_coeff_modulus(JaxCoeffModulus.create(n, bits))
    jp.set_plain_modulus(JaxModulus(t))
    pp = P.EncryptionParameters(P.SchemeType.BFV)
    pp.set_poly_modulus_degree(n)
    pp.set_coeff_modulus(P.CoeffModulus.create(n, bits))
    pp.set_plain_modulus(P.Modulus(t))
    return JaxContext(jp, True, JaxSecurityLevel.NONE), P.SealContext(pp, True, P.SecurityLevel.NONE, device="cpu")


def _qualifiers(cd):
    q = cd.qualifiers
    return (q.parameter_error.value, q.using_fft, q.using_ntt, q.using_batching, q.using_fast_plain_lift,
            q.using_descending_modulus_chain, int(q.sec_level))


@pytest.mark.parametrize("t", [JaxPlainModulus.batching(1024, 20).value, 257, (1 << 40) + 15])
def test_context_constants_equal(t):
    """Delta, q mod t and the lift at every level; 257 is not 1 mod 2N, so
    the context does not batch; 2^40 + 15 lies above a 30-bit prime, so the
    lift is not the fast one."""
    jctx, pctx = _contexts(1024, [30, 45, 45], t)
    jcd, pcd = jctx.key_context_data(), pctx.key_context_data()
    while jcd is not None:
        assert pcd.parms_id == jcd.parms_id
        for name in ("coeff_div_plain_modulus", "upper_half_increment", "coeff_modulus_mod_plain_modulus",
                     "plain_upper_half_threshold", "plain_upper_half_increment"):
            assert getattr(pcd, name) == getattr(jcd, name), name
        assert _qualifiers(pcd) == _qualifiers(jcd)
        jcd, pcd = jcd.next_context_data, pcd.next_context_data
    if t == 257:
        assert not pctx.first_context_data().qualifiers.using_batching


def test_behz_table_bundle_equals_the_tscaled_tables():
    """The q U Bsk bundle transforms forward as the plain tables of q and of
    Bsk do, and inverse as the JAX package's t-scaled tables do."""
    t = JaxPlainModulus.batching(1024, 20).value
    jctx, pctx = _contexts(1024, [40, 40, 40], t)
    jcd, pcd = jctx.first_context_data(), pctx.first_context_data()
    tables = pcd.behz_limb_tables()
    assert tables is pcd.behz_limb_tables() and tables is not pcd.limb_tables()
    k, k_bsk = len(jcd.coeff_modulus_values), jcd.rns_tool.base_Bsk.size
    assert tables.moduli_values == tuple(jcd.coeff_modulus_values) + tuple(jcd.rns_tool.base_Bsk.values)
    rng = np.random.default_rng(3)
    q = np.array(tables.moduli_values, dtype=np.uint64).reshape(-1, 1)
    x = (rng.integers(0, 1 << 62, size=(2, k + k_bsk, 1024), dtype=np.uint64) % q).astype(np.uint64)

    def jax_ntt(fn, part, tab):
        return JU.to_np_u64(jax.jit(lambda a: fn(a, tab))(JU.from_np_u64(part)))

    jq, jb = x[:, :k], x[:, k:]
    want_inv = np.concatenate([jax_ntt(JNTT.ntt_inverse, jq, jcd.tscaled_limb_tables("q")),
                               jax_ntt(JNTT.ntt_inverse, jb, jcd.tscaled_limb_tables("bsk"))], axis=1)
    want_fwd = np.concatenate([jax_ntt(JNTT.ntt_forward, jq, jcd.limb_tables()),
                               jax_ntt(JNTT.ntt_forward, jb, jcd.bsk_limb_tables())], axis=1)
    np.testing.assert_array_equal(u64_to_numpy(NTT.inverse(u64_from_numpy(x, "cpu"), tables)), want_inv)
    np.testing.assert_array_equal(u64_to_numpy(NTT.forward(u64_from_numpy(x, "cpu"), tables)), want_fwd)


@pytest.fixture(scope="module")
def encoders():
    t = JaxPlainModulus.batching(1024, 20).value
    jctx, pctx = _contexts(1024, [40, 40, 40], t)
    return JaxBatchEncoder(jctx), BatchEncoder(pctx), t


def test_host_c_ntt_tables_equal():
    mod = JaxPlainModulus.batching(1024, 20)
    jt, pt = jax_host_c_ntt_tables(10, mod), host_c_ntt_tables(10, P.Modulus(mod.value))
    assert jt.keys() == pt.keys()
    for name, value in jt.items():
        np.testing.assert_array_equal(pt[name], value, err_msg=name)


def test_batch_encoder_equals_jax(encoders):
    je, pe, t = encoders
    rng = np.random.default_rng(11)
    np.testing.assert_array_equal(pe.index_map, je.index_map)
    for values in (rng.integers(0, t, size=1024, dtype=np.uint64), np.arange(7, dtype=np.uint64),
                   np.full(1024, t - 1, dtype=np.uint64), [1, 2, 3]):
        jp, pp = je.encode(values), pe.encode(values)
        np.testing.assert_array_equal(pp.coeff_data, jp.coeff_data)
        assert not pp.is_ntt_form
        np.testing.assert_array_equal(pe.decode(pp), je.decode(jp))
        np.testing.assert_array_equal(pe.decode(pp)[: len(values)], np.asarray(values, dtype=np.uint64))
    signed = rng.integers(-(t >> 1), (t - 1) >> 1, size=1024, dtype=np.int64)
    jp, pp = je.encode_int64(signed), pe.encode_int64(signed)
    np.testing.assert_array_equal(pp.coeff_data, jp.coeff_data)
    np.testing.assert_array_equal(pe.decode_int64(pp), je.decode_int64(jp))
    np.testing.assert_array_equal(pe.decode_int64(pp), signed)


def test_batch_encoder_rejections_equal(encoders):
    je, pe, t = encoders
    cases = [
        (lambda e: e.encode([t]), "input value is larger than plain_modulus"),
        (lambda e: e.encode(np.zeros(1025, dtype=np.uint64)), "values_matrix size is too large"),
        (lambda e: e.encode(np.zeros((2, 2), dtype=np.uint64)), "values_matrix must be one-dimensional"),
        (lambda e: e.encode_int64([(t >> 1) + 1]), "input value is out of range"),
    ]
    for fn, message in cases:
        for enc in (je, pe):
            with pytest.raises(ValueError, match=message):
                fn(enc)
    ckks = P.EncryptionParameters(P.SchemeType.CKKS)
    ckks.set_poly_modulus_degree(1024)
    ckks.set_coeff_modulus(P.CoeffModulus.create(1024, [40, 40]))
    with pytest.raises(ValueError, match="unsupported scheme"):
        BatchEncoder(P.SealContext(ckks, True, P.SecurityLevel.NONE, device="cpu"))
    _, no_batching = _contexts(1024, [40, 40], 257)
    with pytest.raises(ValueError, match="not valid for batching"):
        BatchEncoder(no_batching)
