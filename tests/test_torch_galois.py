"""The port's Galois tables, polynomial ops and Galois keys against the JAX package.

(a) ``make_galois_table_ntt`` and ``make_galois_table_coeff`` (vectorised
    numpy in the port, Python loops in the JAX package) for every odd
    element at n <= 64 and for ``get_elts_all(n)`` at n in {1024, 4096,
    32768}; ``get_elt_from_step`` and ``get_elts_all``; the context's
    ``GaloisTool`` and its per-device index tensors;
(b) ``negacyclic_shift``, ``mono_multiply``, ``apply_galois_ntt``,
    ``apply_galois_coeff`` and the scalar ops on splitmix64 residues;
(c) ``create_galois_keys()`` (every element) and
    ``create_galois_keys_from_steps([1, -3, 5])`` at CKKS N=1024, bits
    [60, 40, 40, 40, 60], with the seeded BLAKE2XB factory: every key equal,
    so the random stream is drawn in the same order.

The JAX side samples on the host (``SEAL_TPU_DEVICE_SAMPLING=0``).  Every
comparison is exact.
"""

import numpy as np
import pytest
import torch

from seal_tpu.context import SealContext as JaxContext
from seal_tpu.keygen import KeyGenerator as JaxKeyGenerator
from seal_tpu.modulus import CoeffModulus as JaxCoeffModulus, SecurityLevel as JaxSecurityLevel
from seal_tpu.ops import poly as JP
from seal_tpu.ops import u64 as JU
from seal_tpu.ops.rns import _c as jax_c, _cshoup as jax_cshoup
from seal_tpu.params import EncryptionParameters as JaxParameters, SchemeType as JaxScheme
from seal_tpu.random import PRNGType as JaxPRNGType, UniformRandomGeneratorFactory as JaxFactory

import seal_tpu_torch as P
from seal_tpu_torch import convert as C
from seal_tpu_torch import golden
from seal_tpu_torch.ntt_tables import build_limb_tables
from seal_tpu_torch.ops import poly as PP
from seal_tpu_torch.ops.rns import _c, _cshoup

N = 1024
BITS = [60, 40, 40, 40, 60]
SEED = (1, 2, 3, 4, 5, 6, 7, 8)


def _eq(jax_value, port_tensor):
    np.testing.assert_array_equal(JU.to_np_u64(jax_value), C.u64_to_numpy(port_tensor))


# -- (a) tables ----------------------------------------------------------------

def _same_tables(n, elts):
    for elt in elts:
        want = JP.make_galois_table_ntt(n, elt)
        got = PP.make_galois_table_ntt(n, elt)
        assert got.dtype == want.dtype and np.array_equal(got, want), (n, elt)
        (ws, wn), (gs, gn) = JP.make_galois_table_coeff(n, elt), PP.make_galois_table_coeff(n, elt)
        assert gs.dtype == ws.dtype and gn.dtype == wn.dtype, (n, elt)
        assert np.array_equal(gs, ws) and np.array_equal(gn, wn), (n, elt)


@pytest.mark.parametrize("n", [2, 8, 16, 32, 64])
def test_tables_equal_jax_for_every_odd_element(n):
    _same_tables(n, range(1, 2 * n, 2))


@pytest.mark.parametrize("n", [1024, 4096, 32768])
def test_tables_equal_jax_for_every_rotation_element(n):
    assert PP.get_elts_all(n) == JP.get_elts_all(n)
    _same_tables(n, PP.get_elts_all(n))


@pytest.mark.parametrize("n", [8, 1024, 32768])
def test_elements_from_steps_equal_jax(n):
    for step in range(-(n // 2) + 1, n // 2, max(1, n // 64)):
        assert PP.get_elt_from_step(step, n) == JP.get_elt_from_step(step, n)
    for step in (n // 2, -(n // 2)):
        with pytest.raises(ValueError, match="step count too large"):
            PP.get_elt_from_step(step, n)


def test_galois_tool_caches_host_tables_and_device_indices(keygens):
    _, pkg = keygens
    tool = pkg.context.first_context_data().galois_tool
    assert tool.n == N and tool.get_elt_from_step(1) == golden.LINEAR_GALOIS_ELT
    assert tool.get_elts_from_steps([0, 1, -1]) == [2 * tool.n - 1, 3, JP.get_elt_from_step(-1, tool.n)]
    assert tool.get_index_from_elt(7) == 3
    idx = tool.ntt_index(3, "cpu")
    assert idx.dtype == torch.int64 and idx is tool.ntt_index(3, torch.device("cpu"))
    assert np.array_equal(idx.numpy(), JP.make_galois_table_ntt(tool.n, 3))
    src, neg = tool.coeff_table(5)
    assert src is tool.coeff_table(5)[0]
    want_src, want_neg = JP.make_galois_table_coeff(tool.n, 5)
    assert np.array_equal(src, want_src) and np.array_equal(neg, want_neg)


# -- (b) polynomial ops ---------------------------------------------------------

@pytest.fixture(scope="module")
def residues():
    moduli = [m.value for m in P.CoeffModulus.create(64, [40, 30, 50])]
    x = golden.splitmix64(7, 2 * 3 * 64).reshape(2, 3, 64) % np.array(moduli, dtype=np.uint64)[:, None]
    t = build_limb_tables(6, [P.Modulus(q) for q in moduli], device="cpu")
    return moduli, x, t


@pytest.mark.parametrize("shift", [0, 1, 5, 63, 64, 65, 127, 300])
def test_negacyclic_shift_and_mono_multiply_equal_jax(residues, shift):
    moduli, x, t = residues
    jq = jax_c(moduli)
    _eq(JP.negacyclic_shift(JU.from_np_u64(x), shift, jq), PP.negacyclic_shift(C.u64_from_numpy(x, "cpu"), shift, t.q))
    mono = [(q - 1 - 7 * shift) % q for q in moduli]
    jmono = jax_c(mono)
    jr_lo, jr_hi = jax_c([(1 << 128) // q & ((1 << 64) - 1) for q in moduli]), jax_c([(1 << 128) // q >> 64 for q in moduli])
    want = JP.mono_multiply(JU.from_np_u64(x), jmono, shift, jq, jr_lo, jr_hi)
    got = PP.mono_multiply(C.u64_from_numpy(x, "cpu"), _c(mono, "cpu"), shift, t.q, t.ratio_lo, t.ratio_hi)
    _eq(want, got)


@pytest.mark.parametrize("elt", [3, 5, 127, 25])
def test_apply_galois_equals_jax(residues, elt):
    moduli, x, t = residues
    px = C.u64_from_numpy(x, "cpu")
    table = JP.make_galois_table_ntt(64, elt)
    _eq(JP.apply_galois_ntt(JU.from_np_u64(x), table),
        PP.apply_galois_ntt(px, torch.from_numpy(table.astype(np.int64))))
    src, neg = JP.make_galois_table_coeff(64, elt)
    _eq(JP.apply_galois_coeff(JU.from_np_u64(x), src, neg, jax_c(moduli)),
        PP.apply_galois_coeff(px, torch.from_numpy(src.astype(np.int64)), torch.from_numpy(neg), t.q))


def test_scalar_ops_equal_jax(residues):
    moduli, x, t = residues
    jx, px = JU.from_np_u64(x), C.u64_from_numpy(x, "cpu")
    s = [(q // 3) | 1 for q in moduli]
    jop, jqt = jax_cshoup(s, moduli)
    pop, pqt = _cshoup(s, moduli, "cpu")
    _eq(JP.mul_scalar_shoup(jx, jop, jqt, jax_c(moduli)), PP.mul_scalar_shoup(px, pop, pqt, t.q))
    jr_lo, jr_hi = jax_c([(1 << 128) // q & ((1 << 64) - 1) for q in moduli]), jax_c([(1 << 128) // q >> 64 for q in moduli])
    _eq(JP.mul_scalar(jx, jax_c(s), jax_c(moduli), jr_lo, jr_hi), PP.mul_scalar(px, _c(s, "cpu"), t.q, t.ratio_lo, t.ratio_hi))
    wide = golden.splitmix64(9, 3 * 64).reshape(3, 64)
    _eq(JP.reduce_coeffs(JU.from_np_u64(wide), jax_c(moduli), jr_hi),
        PP.reduce_coeffs(C.u64_from_numpy(wide, "cpu"), t.q, t.ratio_hi))


# -- (c) Galois keys -------------------------------------------------------------

@pytest.fixture(scope="module")
def keygens():
    """Both packages' key generators on the same seeded factory."""
    jp = JaxParameters(JaxScheme.CKKS)
    jp.set_poly_modulus_degree(N)
    jp.set_coeff_modulus(JaxCoeffModulus.create(N, BITS))
    jp.set_random_generator(JaxFactory(JaxPRNGType.BLAKE2XB, SEED))
    pp = P.EncryptionParameters(P.SchemeType.CKKS)
    pp.set_poly_modulus_degree(N)
    pp.set_coeff_modulus(P.CoeffModulus.create(N, BITS))
    pp.set_random_generator(C.factory_from_settings(*C.factory_to_settings(jp.random_generator)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAL_TPU_DEVICE_SAMPLING", "0")
        jkg = JaxKeyGenerator(JaxContext(jp, True, JaxSecurityLevel.NONE))
    pkg = P.KeyGenerator(P.SealContext(pp, True, P.SecurityLevel.NONE, device="cpu"))
    return jkg, pkg


def _same_keys(jgk, pgk):
    assert pgk.parms_id == jgk.parms_id and len(pgk.keys) == len(jgk.keys) == N
    present = [i for i, k in enumerate(jgk.keys) if k is not None]
    assert present == [i for i, k in enumerate(pgk.keys) if k is not None]
    for i in present:
        for part in ("c0", "c1"):
            _eq(jgk.keys[i][part], pgk.keys[i][part])
    return present


@pytest.mark.parametrize("which", ["all elements", "steps [1, -3, 5]"])
def test_galois_keys_match_jax(keygens, which):
    jkg, pkg = keygens
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAL_TPU_DEVICE_SAMPLING", "0")
        if which == "all elements":
            jgk, pgk = jkg.create_galois_keys(), pkg.create_galois_keys()
        else:
            jgk, pgk = jkg.create_galois_keys_from_steps([1, -3, 5]), pkg.create_galois_keys_from_steps([1, -3, 5])
    present = _same_keys(jgk, pgk)
    assert len(present) == (len(set(PP.get_elts_all(N))) if which == "all elements" else 3)
    # the numpy carriage of keys between the packages
    keys, pid = C.galois_keys_to_numpy(pgk)
    back = C.galois_keys_from_numpy(keys, pid, "cpu")
    assert all(torch.equal(back.keys[i]["c0"], pgk.keys[i]["c0"]) for i in present)


def test_galois_keys_skip_repeats_and_reject_bad_elements(keygens):
    """A repeated element is sampled once, in the given order; an even or
    too large element raises."""
    jkg, pkg = keygens
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAL_TPU_DEVICE_SAMPLING", "0")
        jgk, pgk = jkg.create_galois_keys([5, 3, 5, 2 * N - 1]), pkg.create_galois_keys([5, 3, 5, 2 * N - 1])
        assert _same_keys(jgk, pgk) == [1, 2, N - 1]
        for bad in (4, 2 * N + 1):
            with pytest.raises(ValueError, match="Galois element is not valid"):
                jkg.create_galois_keys([3, bad])
            with pytest.raises(ValueError, match="Galois element is not valid"):
                pkg.create_galois_keys([3, bad])
