"""The port's u64 arithmetic on int64 against ``seal_tpu.ops.u64``.

Each op of the port's ``ops/u64.py`` runs on the same inputs as the JAX
package's op, element for element: the edge values of
``tests/test_u64_edges.py`` (0, 1, q-1, 2q-1, 4q-1, 2^62-1, lane seams and
64-bit extremes) plus seeded random values, for each modulus class.  Exact
equality: the ops are integer arithmetic.
"""

import numpy as np
import pytest
import torch

from seal_tpu.ops import u64 as JU
from seal_tpu.rns_host import shoup_pair

from seal_tpu_torch.convert import u64_from_numpy, u64_to_numpy
from seal_tpu_torch.ops import u64 as U

M64 = (1 << 64) - 1

EDGE_VALUES = [
    0, 1, 2, 3,
    0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x100000000,
    0x5555555555555555, 0xAAAAAAAAAAAAAAAA,
    (1 << 61) - 1, 1 << 61, (1 << 62) - 1, (1 << 63) - 1, 1 << 63,
    M64 - 1, M64,
]

MODULI = [
    3, 257, 65537,
    (1 << 30) + 0x35,
    0x7FFFFFFFE0001,             # 51-bit NTT prime shape
    (1 << 60) - 0x11FF7,         # near-2^60
    2305843009213693951,         # 2^61 - 1
]

RANDOM = 200


def _rng(q):
    return np.random.default_rng(q % (1 << 32))


def _below(bound, q):
    """Edge values of [0, bound) for modulus q, then seeded random ones."""
    edges = [0, 1, q - 1, 2 * q - 1, 4 * q - 1, (1 << 62) - 1] + EDGE_VALUES
    vals = [v for v in edges if v < bound]
    rnd = _rng(q).integers(0, bound, RANDOM, dtype=np.uint64, endpoint=False)
    return np.array(vals, dtype=np.uint64), rnd


def _sample(bound, q):
    a, b = _below(bound, q)
    return np.concatenate([a, b])


def _full64(q, count):
    rnd = _rng(q + 1).integers(0, M64, count, dtype=np.uint64, endpoint=True)
    return rnd


def _pair_inputs(bound_x, bound_y, q):
    x = _sample(bound_x, q)
    y = _sample(bound_y, q)
    m = min(len(x), len(y))
    # every edge of x against every edge of y, then the random tails paired
    xe, _ = _below(bound_x, q)
    ye, _ = _below(bound_y, q)
    gx, gy = np.meshgrid(xe, ye, indexing="ij")
    return np.concatenate([gx.ravel(), x[:m]]), np.concatenate([gy.ravel(), y[:m]])


def _t(a):
    return u64_from_numpy(np.asarray(a, dtype=np.uint64), "cpu")


def _np(x):
    return u64_to_numpy(x)


def _const(v, n):
    return np.full(n, v, dtype=np.uint64)


def _ratio(q):
    r = (1 << 128) // q
    return r & M64, r >> 64


@pytest.mark.parametrize("q", MODULI)
def test_add_sub_neg_mod(q):
    x, y = _pair_inputs(q, q, q)
    qa = _const(q, len(x))
    jq = JU.from_np_u64(qa)
    for port, jax_op in ((U.add_mod, JU.add_mod), (U.sub_mod, JU.sub_mod)):
        want = JU.to_np_u64(jax_op(JU.from_np_u64(x), JU.from_np_u64(y), jq))
        np.testing.assert_array_equal(_np(port(_t(x), _t(y), _t(qa))), want)
    want = JU.to_np_u64(JU.neg_mod(JU.from_np_u64(x), jq))
    np.testing.assert_array_equal(_np(U.neg_mod(_t(x), _t(qa))), want)


@pytest.mark.parametrize("q", MODULI)
def test_barrett_reduce_64(q):
    x = np.concatenate([np.array(EDGE_VALUES, dtype=np.uint64), _sample(4 * q, q), _full64(q, RANDOM)])
    qa = _const(q, len(x))
    rhi = _const(_ratio(q)[1], len(x))
    want = JU.to_np_u64(JU.barrett_reduce_64(JU.from_np_u64(x), JU.from_np_u64(qa), JU.from_np_u64(rhi)))
    got = _np(U.barrett_reduce_64(_t(x), _t(qa), _t(rhi)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.array([int(v) % q for v in x], dtype=np.uint64))


@pytest.mark.parametrize("q", MODULI)
def test_barrett_reduce_128(q):
    lo = np.concatenate([np.array(EDGE_VALUES, dtype=np.uint64), _full64(q, RANDOM)])
    hi = np.concatenate([_below(q, q)[0], _sample(q, q)])[: len(lo)]
    hi = np.resize(hi, len(lo))
    n = len(lo)
    qa = _const(q, n)
    rlo, rhi = _const(_ratio(q)[0], n), _const(_ratio(q)[1], n)
    want = JU.to_np_u64(JU.barrett_reduce_128(
        JU.from_np_u64(lo) + JU.from_np_u64(hi), JU.from_np_u64(qa),
        JU.from_np_u64(rlo), JU.from_np_u64(rhi)))
    got = _np(U.barrett_reduce_128((_t(lo), _t(hi)), _t(qa), _t(rlo), _t(rhi)))
    np.testing.assert_array_equal(got, want)
    exact = [((int(h) << 64) | int(l)) % q for l, h in zip(lo, hi)]
    np.testing.assert_array_equal(got, np.array(exact, dtype=np.uint64))


@pytest.mark.parametrize("q", MODULI)
def test_mul_mod(q):
    x, y = _pair_inputs(4 * q, q, q)
    n = len(x)
    qa = _const(q, n)
    rlo, rhi = _const(_ratio(q)[0], n), _const(_ratio(q)[1], n)
    want = JU.to_np_u64(JU.mul_mod(JU.from_np_u64(x), JU.from_np_u64(y), JU.from_np_u64(qa),
                                   JU.from_np_u64(rlo), JU.from_np_u64(rhi)))
    got = _np(U.mul_mod(_t(x), _t(y), _t(qa), _t(rlo), _t(rhi)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("q", MODULI)
@pytest.mark.parametrize("lazy", [False, True])
def test_mul_mod_shoup(q, lazy):
    x = np.concatenate([np.array(EDGE_VALUES, dtype=np.uint64), _sample(4 * q, q), _full64(q, RANDOM)])
    ys = np.resize(_sample(q, q), len(x))
    yq = np.array([shoup_pair(int(v), q)[1] for v in ys], dtype=np.uint64)
    qa = _const(q, len(x))
    jax_op, port = (JU.mul_mod_shoup_lazy, U.mul_mod_shoup_lazy) if lazy else (JU.mul_mod_shoup, U.mul_mod_shoup)
    want = JU.to_np_u64(jax_op(JU.from_np_u64(x), JU.from_np_u64(ys), JU.from_np_u64(yq), JU.from_np_u64(qa)))
    np.testing.assert_array_equal(_np(port(_t(x), _t(ys), _t(yq), _t(qa))), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_mul64_wide_and_add128(seed):
    e = np.array(EDGE_VALUES, dtype=np.uint64)
    gx, gy = np.meshgrid(e, e, indexing="ij")
    rng = np.random.default_rng(seed)
    x = np.concatenate([gx.ravel(), rng.integers(0, M64, 500, dtype=np.uint64, endpoint=True)])
    y = np.concatenate([gy.ravel(), rng.integers(0, M64, 500, dtype=np.uint64, endpoint=True)])
    w = JU.mul64_wide(JU.from_np_u64(x), JU.from_np_u64(y))
    want_lo, want_hi = JU.to_np_u64((w[0], w[1])), JU.to_np_u64((w[2], w[3]))
    lo, hi = U.mul64_wide(_t(x), _t(y))
    np.testing.assert_array_equal(_np(lo), want_lo)
    np.testing.assert_array_equal(_np(hi), want_hi)
    np.testing.assert_array_equal(_np(U.mulhi64(_t(x), _t(y))), want_hi)
    np.testing.assert_array_equal(_np(U.mullo64(_t(x), _t(y))), want_lo)

    # add128 of two products, wrapping mod 2^128
    w2 = JU.mul64_wide(JU.from_np_u64(y), JU.from_np_u64(x[::-1].copy()))
    s = JU.add128(w, w2)
    lo2, hi2 = U.mul64_wide(_t(y), _t(x[::-1].copy()))
    slo, shi = U.add128((lo, hi), (lo2, hi2))
    np.testing.assert_array_equal(_np(slo), JU.to_np_u64((s[0], s[1])))
    np.testing.assert_array_equal(_np(shi), JU.to_np_u64((s[2], s[3])))


def test_mul64_wide_extremes():
    """The extremes of the 64-bit range, held as negative int64, give the
    exact 128-bit product."""
    x = torch.tensor([-1, -(1 << 63), (1 << 63) - 1], dtype=torch.int64)   # 2^64-1, 2^63, 2^63-1
    lo, hi = U.mul64_wide(x, x)
    vals = [M64, 1 << 63, (1 << 63) - 1]
    for i, v in enumerate(vals):
        p = v * v
        assert int(lo[i]) & M64 == p & M64
        assert int(hi[i]) & M64 == p >> 64
