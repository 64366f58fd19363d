"""Host precompute of the PyTorch port against the JAX package.

Same parameters into both packages: every level's parms_id, every
LimbTables array (the JAX package's lo/hi uint32 words joined into u64) and
the rescale constant inv_q_last_mod_q must be equal.  Exact equality: all
of it is integer arithmetic.
"""

import numpy as np
import pytest

from seal_tpu.context import SealContext as JaxContext
from seal_tpu.modulus import CoeffModulus as JaxCoeffModulus, SecurityLevel as JaxSecurityLevel
from seal_tpu.params import EncryptionParameters as JaxParameters, SchemeType as JaxScheme
from seal_tpu.ops import u64 as JU

from seal_tpu_torch import CoeffModulus, EncryptionParameters, SchemeType, SealContext, SecurityLevel
from seal_tpu_torch.convert import u64_to_numpy
from seal_tpu_torch.ntt_tables import LimbTables

BITS = [60, 40, 40, 40, 60]


def _contexts(n):
    jp = JaxParameters(JaxScheme.CKKS)
    jp.set_poly_modulus_degree(n)
    jp.set_coeff_modulus(JaxCoeffModulus.create(n, BITS))
    pp = EncryptionParameters(SchemeType.CKKS)
    pp.set_poly_modulus_degree(n)
    pp.set_coeff_modulus(CoeffModulus.create(n, BITS))
    return (JaxContext(jp, True, JaxSecurityLevel.NONE),
            SealContext(pp, True, SecurityLevel.NONE, device="cpu"))


@pytest.fixture(scope="module", params=[1024, 8192])
def contexts(request):
    return _contexts(request.param)


def _chain(ctx):
    cd = ctx.key_context_data()
    out = []
    while cd is not None:
        out.append(cd)
        cd = cd.next_context_data
    return out


def test_parms_id_of_every_level(contexts):
    jctx, pctx = contexts
    jchain, pchain = _chain(jctx), _chain(pctx)
    assert len(jchain) == len(pchain) == len(BITS)
    for jcd, pcd in zip(jchain, pchain):
        assert jcd.parms_id == pcd.parms_id
        assert jcd.coeff_modulus_values == pcd.coeff_modulus_values
        assert jcd.chain_index == pcd.chain_index
    assert (jctx.key_parms_id, jctx.first_parms_id, jctx.last_parms_id) == (
        pctx.key_parms_id, pctx.first_parms_id, pctx.last_parms_id)
    assert jctx.using_keyswitching and pctx.using_keyswitching


def test_limb_tables_equal(contexts):
    jctx, pctx = contexts
    for jcd, pcd in zip(_chain(jctx), _chain(pctx)):
        jt, pt = jcd.limb_tables(), pcd.limb_tables()
        for name in LimbTables._fields[: LimbTables.N_ARRAY_FIELDS]:
            want = JU.to_np_u64((getattr(jt, name + "_lo"), getattr(jt, name + "_hi")))
            np.testing.assert_array_equal(u64_to_numpy(getattr(pt, name)), want, err_msg=name)
        assert (jt.log_n, jt.moduli_values, jt.inv_scale) == (pt.log_n, pt.moduli_values, pt.inv_scale)


def test_inv_q_last_mod_q_equal(contexts):
    jctx, pctx = contexts
    for jcd, pcd in zip(_chain(jctx), _chain(pctx)):
        assert jcd.rns_tool.inv_q_last_mod_q == pcd.rns_tool.inv_q_last_mod_q
        assert jcd.base_q.punctured_prod == pcd.base_q.punctured_prod
        assert jcd.base_q.inv_punctured == pcd.base_q.inv_punctured


def test_inv_scale_tier_equal():
    """The inverse transform's 1/n constants with a folded scalar."""
    from seal_tpu.ntt_tables import build_limb_tables as jax_build
    from seal_tpu_torch.ntt_tables import build_limb_tables

    mods = CoeffModulus.create(1024, BITS)
    jmods = JaxCoeffModulus.create(1024, BITS)
    scale = [65537, 3, 1 << 59, 12345678901, 7]
    jt = jax_build(10, jmods, inv_scale=scale)
    pt = build_limb_tables(10, mods, inv_scale=scale, device="cpu")
    for name in ("invn_op", "invn_qt", "invn_last_op", "invn_last_qt"):
        want = JU.to_np_u64((getattr(jt, name + "_lo"), getattr(jt, name + "_hi")))
        np.testing.assert_array_equal(u64_to_numpy(getattr(pt, name)), want, err_msg=name)
    assert pt.inv_scale == jt.inv_scale


@pytest.mark.parametrize("bits,n", [([60, 40, 40, 60], 4096), ([30, 30], 64), ([50] * 3, 2048)])
def test_coeff_modulus_create_equal(bits, n):
    assert [m.value for m in CoeffModulus.create(n, bits)] == [
        m.value for m in JaxCoeffModulus.create(n, bits)]


def test_validation_errors_match():
    """An insecure parameter set is refused the same way by both packages."""
    jp = JaxParameters(JaxScheme.CKKS)
    jp.set_poly_modulus_degree(1024)
    jp.set_coeff_modulus(JaxCoeffModulus.create(1024, BITS))
    pp = EncryptionParameters(SchemeType.CKKS)
    pp.set_poly_modulus_degree(1024)
    pp.set_coeff_modulus(CoeffModulus.create(1024, BITS))
    jctx = JaxContext(jp, True, JaxSecurityLevel.TC128)
    pctx = SealContext(pp, True, SecurityLevel.TC128, device="cpu")
    assert not jctx.parameters_set and not pctx.parameters_set
    assert jctx.parameter_error_name() == pctx.parameter_error_name() == "INVALID_PARAMETERS_INSECURE"
