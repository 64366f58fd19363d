"""The port's plain key-switch contraction against the JAX package's fused
Pallas kernel (``switch_key_contract``, interpret mode), which kernel B
replaces.

n=128, the cases of ``tests/test_pallas_switch_key.py``: CKKS and BGV with
the i == j diagonal, the mixed 60/40 moduli, the BFV no-diagonal case and
the lower-level key trim (the key carries more decomposition rows than the
level has limbs); and the 16 moduli of ``bfv_default(32768)`` (D=15, Rn=16,
the chain of ``golden.MEDIUM_DIGEST``, whose key switch the card fuses into
one launch of kernel B), with and without the diagonal.  Key columns are seeded uniform residues: the contraction's
arithmetic does not depend on how the key was made.  Exact equality.
"""

import jax
import numpy as np
import pytest
import torch

from seal_tpu.context import SealContext as JaxContext
from seal_tpu.modulus import CoeffModulus as JaxCoeffModulus, PlainModulus as JaxPlainModulus
from seal_tpu.modulus import SecurityLevel as JaxSecurityLevel
from seal_tpu.ops import ntt as JNTT
from seal_tpu.ops import u64 as JU
from seal_tpu.ops.pallas_switch_key import switch_key_contract
from seal_tpu.ops.rns import take_limbs as jax_take_limbs
from seal_tpu.params import EncryptionParameters as JaxParameters, SchemeType as JaxScheme

from seal_tpu_torch.convert import u64_from_numpy, u64_to_numpy
from seal_tpu_torch.modulus import Modulus
from seal_tpu_torch.ntt_tables import build_limb_tables
from seal_tpu_torch.ops.cuda_switch_key import switch_key_contract as port_contract
from seal_tpu_torch.ops.cuda_switch_key import switch_key_contract_cuda, switch_key_contract_plain

N = 128


def _jax_context(scheme, bits):
    """``bits``: bit sizes, or the moduli themselves."""
    parms = JaxParameters(scheme)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(bits if not isinstance(bits[0], int) else JaxCoeffModulus.create(N, bits))
    if scheme in (JaxScheme.BFV, JaxScheme.BGV):
        parms.set_plain_modulus(JaxPlainModulus.batching(N, 17))
    return JaxContext(parms, True, JaxSecurityLevel.NONE)


def _case(scheme, bits, lower_level, seed, diag=None):
    """Inputs of one contraction, as numpy uint64, plus the JAX tables;
    ``diag`` None: the scheme's own (CKKS and BGV substitute the diagonal)."""
    ctx = _jax_context(scheme, bits)
    cd = ctx.first_context_data()
    if lower_level:
        cd = cd.next_context_data
    key_cd = ctx.key_context_data()
    key_moduli = key_cd.coeff_modulus_values
    D = len(cd.coeff_modulus_values)
    D_key = len(ctx.first_context_data().coeff_modulus_values)
    sel_idx = list(range(D)) + [len(key_moduli) - 1]
    sel_vals = [key_moduli[i] for i in sel_idx]
    sel_tables = jax_take_limbs(key_cd.limb_tables(), sel_idx)
    need_reduce = np.array([[qj > qi for qi in sel_vals] for qj in cd.coeff_modulus_values])

    rng = np.random.default_rng(seed)
    qv = np.array(cd.coeff_modulus_values, dtype=np.uint64).reshape(-1, 1)
    target = rng.integers(0, 1 << 62, (D, N), dtype=np.uint64) % qv
    sel_q = np.array(sel_vals, dtype=np.uint64).reshape(1, 1, -1, 1)
    key = rng.integers(0, 1 << 62, (2, D_key, len(sel_vals), N), dtype=np.uint64) % sel_q
    if diag is None:
        diag = scheme in (JaxScheme.CKKS, JaxScheme.BGV)
    if diag:
        t_c = JU.to_np_u64(jax.jit(lambda v: JNTT.ntt_inverse(v, cd.limb_tables()))(JU.from_np_u64(target)))
        t_n = target
    else:
        t_c, t_n = target, None
    return sel_vals, sel_tables, need_reduce, t_c, t_n, key


CASES = {
    "ckks_diag": (JaxScheme.CKKS, [40, 30, 30, 40], False),
    "bgv_diag": (JaxScheme.BGV, [40, 30, 30, 40], False),
    "ckks_mixed_60_40": (JaxScheme.CKKS, [60, 40, 40, 60], False),
    "bfv_no_diag": (JaxScheme.BFV, [40, 30, 30, 40], False),
    "ckks_lower_level_trim": (JaxScheme.CKKS, [40, 30, 30, 40], True),
}


def _check_against_pallas(sel_vals, sel_tables, need_reduce, t_c, t_n, key):
    want = switch_key_contract(
        JU.from_np_u64(t_c), None if t_n is None else JU.from_np_u64(t_n), JU.from_np_u64(key),
        JNTT._mxu_tables_for(sel_tables), need_reduce, interpret=True)
    want = JU.to_np_u64(want)

    tables = build_limb_tables(7, [Modulus(v) for v in sel_vals], device="cpu")
    got = port_contract(
        u64_from_numpy(t_c, "cpu"), None if t_n is None else u64_from_numpy(t_n, "cpu"),
        u64_from_numpy(key, "cpu"), tables, torch.from_numpy(need_reduce))
    np.testing.assert_array_equal(u64_to_numpy(got), want)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_kernel(case):
    scheme, bits, lower = CASES[case]
    sel_vals, sel_tables, need_reduce, t_c, t_n, key = _case(scheme, bits, lower, seed=len(case))
    if lower:
        assert key.shape[1] > t_c.shape[0]  # the key really has extra rows
    _check_against_pallas(sel_vals, sel_tables, need_reduce, t_c, t_n, key)


@pytest.mark.parametrize("diag", [True, False])
def test_plain_matches_pallas_kernel_on_the_default_32768_chain(diag):
    """The 16 moduli of bfv_default(32768) at n=128: D=15, Rn=16, 240 grid
    steps of the Pallas kernel in interpret mode (about 5 s each)."""
    moduli = JaxCoeffModulus.bfv_default(32768)
    sel_vals, sel_tables, need_reduce, t_c, t_n, key = _case(JaxScheme.CKKS, moduli, False, seed=15, diag=diag)
    assert t_c.shape[0] == 15 and len(sel_vals) == 16 and need_reduce.any() and not need_reduce.all()
    _check_against_pallas(sel_vals, sel_tables, need_reduce, t_c, t_n, key)


def test_guard_every_64_summands():
    """D=66 > 64: the u128 sum is Barrett-reduced after 64 summands; the
    result equals the exact contraction computed with Python ints."""
    D, Rn, n = 66, 67, 16
    from seal_tpu_torch.numth import get_primes

    qs = get_primes(2 * n, 60, Rn)
    tables = build_limb_tables(4, [Modulus(v) for v in qs], device="cpu")
    rng = np.random.default_rng(3)
    t_c = np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in qs[:D]])
    key = np.stack([np.stack([np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in qs])
                              for _ in range(D)]) for _ in range(2)])
    need_reduce = np.array([[qj > qi for qi in qs] for qj in qs[:D]])
    got = u64_to_numpy(switch_key_contract_plain(
        u64_from_numpy(t_c, "cpu"), None, u64_from_numpy(key, "cpu"), tables, torch.from_numpy(need_reduce)))

    from seal_tpu_torch.ops.ntt import ntt_forward

    # exact reference: per (j, i) NTT of t_c[j] mod q_i, then the dot product
    red = np.stack([[np.array([int(v) % qi for v in t_c[j]], dtype=np.uint64) for qi in qs] for j in range(D)])
    ntt = u64_to_numpy(ntt_forward(u64_from_numpy(red, "cpu"), tables))
    for c in range(2):
        for i, qi in enumerate(qs):
            exact = [sum(int(ntt[j, i, x]) * int(key[c, j, i, x]) for j in range(D)) % qi for x in range(n)]
            np.testing.assert_array_equal(got[c, i], np.array(exact, dtype=np.uint64))


def test_contract_sends_n_up_to_32768_to_the_kernel(monkeypatch):
    """On the card, switch_key_contract launches kernel B up to n = 32768
    (log_n 15), the JAX package's fused range, and the staged formulation
    above it; the kernel's wrapper takes n = 32768 and refuses 65536."""
    from seal_tpu_torch.ops import cuda_switch_key as SK

    calls = []

    def fake_kernel(t_c, t_n, key, t, need_reduce, row_offset=0):
        calls.append(t.log_n)
        return switch_key_contract_plain(t_c, t_n, key, t, need_reduce, row_offset=row_offset)

    from seal_tpu_torch.numth import get_primes

    monkeypatch.setattr(SK, "use_kernels", lambda x: True)
    monkeypatch.setattr(SK, "switch_key_contract_cuda", fake_kernel)
    qs = get_primes(1 << 17, 30, 2)
    for log_n in (15, 16):
        n = 1 << log_n
        tables = build_limb_tables(log_n, [Modulus(v) for v in qs], device="cpu")
        rng = np.random.default_rng(log_n)
        t_c = torch.from_numpy(rng.integers(0, min(qs), (1, n), dtype=np.int64))
        key = torch.from_numpy(rng.integers(0, min(qs), (2, 1, 2, n), dtype=np.int64))
        need = torch.tensor([[False, False]])
        got = SK.switch_key_contract(t_c, None, key, tables, need)
        assert torch.equal(got, switch_key_contract_plain(t_c, None, key, tables, need))
        with pytest.raises(ValueError, match="CUDA" if log_n == 15 else "n <= 32768"):
            SK._check_inputs(t_c, None, key, tables, need, 0)
    assert calls == [15]


def test_cuda_wrapper_refuses_cpu_tensors():
    tables = build_limb_tables(4, [Modulus(v) for v in (97, 193)], device="cpu")
    t_c = torch.zeros((1, 16), dtype=torch.int64)
    key = torch.zeros((2, 1, 2, 16), dtype=torch.int64)
    with pytest.raises(ValueError):
        switch_key_contract_cuda(t_c, None, key, tables, torch.zeros((1, 2), dtype=torch.bool))
