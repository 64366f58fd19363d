"""The port's BEHZ operations (``seal_tpu_torch/ops/rns.py``) against the JAX
package's, on the same numpy inputs from a seed.

(a) ``fast_convert_array``: a 70-limb input base (past the JAX package's
    Barrett guard every 64 summands) into 60-bit primes and m_tilde = 2^32,
    on uniform residues and on the largest residues q_i - 1; and a 260-limb
    input base (past the port's exact window of 256 summands) against the
    conversion computed with Python ints;
(b) ``sm_mrq``, on inputs that reach both branches of the centred m_tilde
    residue (r < m_tilde / 2 and r >= m_tilde / 2);
(c) ``fastbconv_m_tilde``, ``fast_floor``, ``fastbconv_sk``;
(d) ``divide_and_round_q_last`` (BFV's modulus switch) and
    ``decrypt_scale_and_round`` (BFV's decryption tail);

for the BEHZ tools of ``bfv_default(8192)`` with ``t =
PlainModulus.batching(8192, 20)`` and of a small chain.  Each JAX function
runs eagerly on the CPU (at these sizes faster than compiling it), the
port's on CPU tensors (the plain versions).  Exact equality throughout.
"""

import numpy as np
import pytest

from seal_tpu.modulus import (CoeffModulus as JaxCoeffModulus, Modulus as JaxModulus,
                              PlainModulus as JaxPlainModulus)
from seal_tpu.ops import rns as JR
from seal_tpu.ops import u64 as JU
from seal_tpu.rns_host import HostBaseConverter as JaxConverter, HostRNSBase as JaxBase, HostRNSTool as JaxTool

import seal_tpu_torch as P
from seal_tpu_torch.convert import u64_from_numpy, u64_to_numpy
from seal_tpu_torch.ops import rns as R
from seal_tpu_torch.rns_host import HostBaseConverter, HostRNSBase, HostRNSTool

N = 256


def _residues(rng, values, lead=()):
    q = np.array(values, dtype=np.uint64).reshape(-1, 1)
    return rng.integers(0, 1 << 63, size=(*lead, len(values), N), dtype=np.uint64) % q


def _jax(fn, x):
    return JU.to_np_u64(fn(JU.from_np_u64(x)))


def _port(fn, x):
    return u64_to_numpy(fn(u64_from_numpy(x, "cpu")))


def _bases(in_bits, count, out):
    """An input base of ``count`` primes and the output base ``out``
    (values), in both packages."""
    ins = [m.value for m in JaxCoeffModulus.create(2 * N, [in_bits] * count)]
    return ((JaxBase([JaxModulus(v) for v in ins]), JaxBase([JaxModulus(v) for v in out])),
            (HostRNSBase([P.Modulus(v) for v in ins]), HostRNSBase([P.Modulus(v) for v in out])))


def test_fast_convert_array_past_the_64_summand_guard():
    """Uniform residues (row 0) and the largest residues q_i - 1 (row 1)."""
    out = [m.value for m in JaxCoeffModulus.create(4 * N, [60, 60, 50])] + [1 << 32]
    (jin, jout), (pin, pout) = _bases(60, 70, out)
    jconv, pconv = JaxConverter(jin, jout), HostBaseConverter(pin, pout)
    uniform = _residues(np.random.default_rng(1), pin.values)
    largest = np.broadcast_to(np.array(pin.values, dtype=np.uint64)[:, None] - np.uint64(1), (70, N))
    x = np.stack([uniform, largest])
    want = _jax(lambda a: JR.fast_convert_array(a, jconv), x)
    got = _port(lambda a: R.fast_convert_array(a, pconv), x)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, len(out), N)


def test_fast_convert_array_past_the_exact_window():
    """260 input limbs: the sum runs in two windows, added mod p_j."""
    out = [m.value for m in JaxCoeffModulus.create(8, [58, 57])]
    ins = [m.value for m in JaxCoeffModulus.create(8, [60] * 200) + JaxCoeffModulus.create(8, [59] * 60)]
    conv = HostBaseConverter(HostRNSBase([P.Modulus(v) for v in ins]), HostRNSBase([P.Modulus(v) for v in out]))
    x = np.array(ins, dtype=np.uint64)[:, None] - np.arange(1, 5, dtype=np.uint64)[None, :]   # (260, 4)
    got = u64_to_numpy(R.fast_convert_array(u64_from_numpy(x, "cpu"), conv))
    base = conv.ibase
    for c in range(x.shape[1]):
        value = sum(int(x[i, c]) * base.inv_punctured[i] % q * base.punctured_prod[i] for i, q in enumerate(ins))
        assert [int(v) for v in got[:, c]] == [value % p for p in out]


TOOLS = {
    "bfv_default(8192)": (8192, lambda: JaxCoeffModulus.bfv_default(8192), lambda: JaxPlainModulus.batching(8192, 20)),
    "small": (1024, lambda: JaxCoeffModulus.create(1024, [30, 30, 30]), lambda: JaxPlainModulus.batching(1024, 16)),
}


@pytest.fixture(scope="module", params=list(TOOLS))
def tools(request):
    n, moduli, t = TOOLS[request.param]
    qs, tv = [m.value for m in moduli()], t().value
    return (JaxTool(n, JaxBase([JaxModulus(q) for q in qs]), JaxModulus(tv)),
            HostRNSTool(n, HostRNSBase([P.Modulus(q) for q in qs]), P.Modulus(tv)))


def test_fastbconv_m_tilde_equal(tools):
    jt, pt = tools
    x = _residues(np.random.default_rng(2), pt.base_q.values, (3,))
    np.testing.assert_array_equal(_port(lambda a: R.fastbconv_m_tilde(a, pt), x),
                                  _jax(lambda a: JR.fastbconv_m_tilde(a, jt), x))


def test_sm_mrq_equal_on_both_branches(tools):
    jt, pt = tools
    x = _residues(np.random.default_rng(3), pt.base_Bsk_m_tilde.values, (2,))
    r = (x[:, -1].astype(object) * pt.neg_inv_prod_q_mod_m_tilde) % (1 << 32)
    assert (r >= 1 << 31).any() and (r < 1 << 31).any()
    np.testing.assert_array_equal(_port(lambda a: R.sm_mrq(a, pt), x), _jax(lambda a: JR.sm_mrq(a, jt), x))


def test_fast_floor_equal(tools):
    jt, pt = tools
    x = _residues(np.random.default_rng(4), pt.base_q.values + pt.base_Bsk.values, (3,))
    np.testing.assert_array_equal(_port(lambda a: R.fast_floor(a, pt), x), _jax(lambda a: JR.fast_floor(a, jt), x))


def test_fastbconv_sk_equal(tools):
    jt, pt = tools
    x = _residues(np.random.default_rng(5), pt.base_Bsk.values, (3,))
    np.testing.assert_array_equal(_port(lambda a: R.fastbconv_sk(a, pt), x),
                                  _jax(lambda a: JR.fastbconv_sk(a, jt), x))


def test_divide_and_round_q_last_equal(tools):
    jt, pt = tools
    x = _residues(np.random.default_rng(6), pt.base_q.values)
    got = _port(lambda a: R.divide_and_round_q_last(a, pt), x)
    np.testing.assert_array_equal(got, _jax(lambda a: JR.divide_and_round_q_last(a, jt), x))
    assert got.shape == (pt.base_q.size - 1, N)


def test_decrypt_scale_and_round_equal(tools):
    jt, pt = tools
    x = _residues(np.random.default_rng(7), pt.base_q.values)
    got = _port(lambda a: R.decrypt_scale_and_round(a, pt), x)
    np.testing.assert_array_equal(got, _jax(lambda a: JR.decrypt_scale_and_round(a, jt), x))
    assert got.shape == (1, N) and (got < pt.t.value).all()
