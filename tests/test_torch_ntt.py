"""The port's plain NTT (Harvey butterflies) against the JAX package.

n=2048, three limbs including a 60-bit one, a leading poly axis; forward
inputs spread over [0, 4q), inverse inputs over [0, 2q).  The lazy outputs
must equal JAX's butterflies (its CPU dispatch) exactly; the reduced outputs
must also equal the JAX package's fused Pallas kernel
(``pallas_ntt_forward`` / ``pallas_ntt_inverse``, interpret mode), which
kernel A replaces.  Exact equality: the transforms are integer arithmetic.
"""

import jax
import numpy as np
import pytest
import torch

from seal_tpu.modulus import CoeffModulus as JaxCoeffModulus
from seal_tpu.ntt_tables import build_limb_tables as jax_limb_tables, build_mxu_tables
from seal_tpu.ops import ntt as JNTT
from seal_tpu.ops import pallas_mxu_ntt as PL
from seal_tpu.ops import u64 as JU

from seal_tpu_torch.convert import u64_from_numpy, u64_to_numpy
from seal_tpu_torch.modulus import CoeffModulus
from seal_tpu_torch.ntt_tables import build_limb_tables
from seal_tpu_torch.ops import ntt as NTT

N, LOG_N = 2048, 11
BITS = [60, 40, 50]
LEAD = (2,)


@pytest.fixture(scope="module")
def tables():
    jmods = JaxCoeffModulus.create(N, BITS)
    mods = CoeffModulus.create(N, BITS)
    assert [m.value for m in mods] == [m.value for m in jmods]
    return jmods, mods, jax_limb_tables(LOG_N, jmods), build_limb_tables(LOG_N, mods, device="cpu")


def _inputs(mods, factor, seed):
    q = np.array([m.value for m in mods], dtype=np.uint64).reshape(-1, 1) * np.uint64(factor)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 62, (*LEAD, len(mods), N), dtype=np.uint64) % q
    x[..., 0] = q[:, 0] - np.uint64(1)          # the top of the lazy range
    x[..., 1] = 0
    return x


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
def test_butterflies_match_jax(tables, inverse, lazy):
    jmods, mods, jt, pt = tables
    x = _inputs(mods, 2 if inverse else 4, 5 + inverse)
    jax_op, port_op = (JNTT.ntt_inverse, NTT.ntt_inverse) if inverse else (JNTT.ntt_forward, NTT.ntt_forward)
    want = JU.to_np_u64(jax.jit(lambda v: jax_op(v, jt, lazy=lazy))(JU.from_np_u64(x)))
    got = u64_to_numpy(port_op(u64_from_numpy(x, "cpu"), pt, lazy=lazy))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("inverse", [False, True])
def test_reduced_output_matches_pallas_kernel(tables, inverse):
    jmods, mods, jt, pt = tables
    mt = build_mxu_tables(LOG_N, jmods)
    x = _inputs(mods, 2 if inverse else 4, 7 + inverse)
    pallas_op = PL.pallas_ntt_inverse if inverse else PL.pallas_ntt_forward
    want = JU.to_np_u64(pallas_op(JU.from_np_u64(x), mt, interpret=True))
    port_op = NTT.ntt_inverse if inverse else NTT.ntt_forward
    got = u64_to_numpy(port_op(u64_from_numpy(x, "cpu"), pt))
    np.testing.assert_array_equal(got, want)


def test_inverse_with_inv_scale_matches_jax():
    """The inv_scale tier folds a scalar into the last inverse stage."""
    jmods = JaxCoeffModulus.create(N, BITS)
    mods = CoeffModulus.create(N, BITS)
    scale = [65537, 1 << 40, 3]
    jt = jax_limb_tables(LOG_N, jmods, inv_scale=scale)
    pt = build_limb_tables(LOG_N, mods, inv_scale=scale, device="cpu")
    x = _inputs(mods, 2, 9)
    want = JU.to_np_u64(jax.jit(lambda v: JNTT.ntt_inverse(v, jt))(JU.from_np_u64(x)))
    got = u64_to_numpy(NTT.ntt_inverse(u64_from_numpy(x, "cpu"), pt))
    np.testing.assert_array_equal(got, want)


def test_roundtrip_and_dispatch_on_cpu(tables):
    """forward/inverse dispatch to the butterflies for CPU tensors."""
    _, mods, _, pt = tables
    x = u64_from_numpy(_inputs(mods, 1, 11), "cpu")
    y = NTT.forward(x, pt)
    assert torch.equal(y, NTT.ntt_forward(x, pt))
    assert torch.equal(NTT.inverse(y, pt), x)


def test_shape_mismatch_raises(tables):
    _, _, _, pt = tables
    with pytest.raises(ValueError):
        NTT.ntt_forward(torch.zeros((2, N), dtype=torch.int64), pt)
    with pytest.raises(ValueError):
        NTT.ntt_inverse(torch.zeros((3, N // 2), dtype=torch.int64), pt)
